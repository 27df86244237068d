"""The Borehole function (Harper & Gupta 1983), water flow through a
borehole, as given in the Virtual Library of Simulation Experiments
(Surjanovic & Bingham, sfu.ca/~ssurjano/borehole.html):

    f = 2 pi Tu (Hu - Hl)
        / (ln(r / rw) (1 + 2 L Tu / (ln(r / rw) rw^2 Kw) + Tu / Tl))

with inputs in the order (rw, r, Tu, Hu, Tl, Hl, L, Kw)."""

import numpy as np


def f(x):
    rw, r, tu, hu, tl, hl, ln, kw = (x[:, i] for i in range(8))
    lr = np.log(r / rw)
    return (2.0 * np.pi * tu * (hu - hl)
            / (lr * (1.0 + 2.0 * ln * tu / (lr * rw * rw * kw) + tu / tl)))
