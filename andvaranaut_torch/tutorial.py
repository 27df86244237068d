"""The end-to-end tutorial through the PyTorch port, call for call the
JAX package's examples/tutorial.py: LHC sampling and deletion, the GP
surrogate's MAP fit, held-out metrics, a model change, forward UQ,
relative importances, Bayesian optimisation, an inverse problem, the
optional MCMC hyperposterior, and pickle persistence.

Run:  python -m andvaranaut_torch.tutorial [--plots] [--mcmc] [--device cpu]

It runs on the CUDA card unless --device names another.  Without
matplotlib and seaborn it propagates the forward UQ without drawing it
(--plots then refuses to start).
"""

import argparse
import importlib.util
import os
import tempfile

import numpy as np

from andvaranaut_torch import GPMCMC, LHC, dists, load_object, save_object
import andvaranaut_torch.transform as tf


def target(x):
    """f(x1, x2) = x1^2 - x1 - x2^2 x1 + x2."""
    return np.array([x[0] ** 2 - x[0] - x[1] ** 2 * x[0] + x[1]])


def _can_plot():
    return all(importlib.util.find_spec(m) is not None
               for m in ("matplotlib", "seaborn"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--plots", action="store_true")
    ap.add_argument("--mcmc", action="store_true",
                    help="also run the NUTS hyperparameter posterior")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    can_plot = _can_plot()
    if args.plots and not can_plot:
        ap.error("--plots needs matplotlib and seaborn")
    if can_plot and not args.plots:
        import matplotlib

        matplotlib.use("Agg")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="andvaranaut_tutorial_") as wd:
        os.chdir(wd)
        try:
            _workflow(args, can_plot)
        finally:
            os.chdir(cwd)


def _workflow(args, can_plot):
    print(f"working in {os.getcwd()}")

    # LHC construction and sampling
    priors = [dists.Uniform(0.0, 2.0), dists.Uniform(1.0, 0.5)]
    lhc = LHC(nx=2, ny=1, priors=priors, target=target)
    lhc.sample(16, seed=0)
    print(f"LHC dataset: x{lhc.x.shape} y{lhc.y.shape}")

    # deletion modes
    lhc.del_samples(ndels=2, method="coarse_lhc")
    lhc.del_samples(ndels=2, method="random")
    lhc.del_samples(method="specific", idx=0)
    print(f"after deletions: nsamp={lhc.nsamp}")

    # GP surrogate with conversion stacks and a MAP fit
    gp = GPMCMC(
        nx=2, ny=1, priors=priors, target=target,
        xconrevs=[tf.uniform(priors[0]), tf.uniform(priors[1])],
        kernel="RBF", noise=True, verbose=True, device=args.device)
    gp.sample(100, seed=5)
    gp.change_yconrevs([tf.meanstd(gp.y[:, 0])])
    gp.fit(method="map")
    print("MAP hypers:", {k: np.asarray(v) for k, v in gp.hypers.items()})

    # train/test split and metrics
    gp.train_test()
    gp.test_plots(yplots=args.plots, xplots=False)

    # change the model to Matern52 and refit
    gp.change_model("Matern52", noise=True)
    gp.fit(method="map")
    gp.train_test()
    gp.test_plots(yplots=False, xplots=False)
    gp.change_model("RBF", noise=True)
    gp.fit(method="map")

    # forward UQ through the surrogate against true evaluations
    if can_plot:
        xs, ys = gp.y_dist(mode="hist_kde", nsamps=1000, return_data=True)
    else:
        print("forward UQ: matplotlib/seaborn not installed, propagated "
              "without the plot")
        xs, ys = gp._forward_uq(1000)
    ytrue = np.array([target(x)[0] for x in xs])
    print(
        f"forward UQ: surrogate mean {ys.mean():.5f} vs true "
        f"{ytrue.mean():.5f}")

    # relative importances
    if args.plots:
        gp.relative_importances()

    # Bayesian optimisation (EI)
    np.random.seed(0)
    xopt, yopt = gp.BO(
        opt_type="min", opt_method="predict", method="EI", max_iter=8,
        predict_samps=2000, refine=False)
    print(f"BO optimum: y={yopt} at x={xopt}")

    # inverse problem: recover x from an observed y
    xtrue = np.array([0.7, 1.2])
    data, xinv = gp.inverse_opt(target(xtrue), method="map")
    print(f"inverse: x={xinv} (ypred {target(xinv)} vs obs "
          f"{target(xtrue)})")

    # optional: the NUTS hyperparameter posterior
    if args.mcmc:
        data = gp.fit(
            method="mcmc_mean", return_data=True, draws=500, tune=500,
            chains=4, random_seed=0)
        print(data.summary())

    # pickle persistence
    save_object(gp, "gp.pkl")
    gp2 = load_object("gp.pkl")
    assert np.allclose(gp2.predict(gp.x[:5]), gp.predict(gp.x[:5]))
    print("pickle round-trip OK")


if __name__ == "__main__":
    main()
