"""The Branin function (Dixon & Szego 1978), as given in the Virtual
Library of Simulation Experiments (Surjanovic & Bingham,
sfu.ca/~ssurjano/branin.html):

    f = a (x2 - b x1^2 + c x1 - r)^2 + s (1 - t) cos(x1) + s

with a = 1, b = 5.1 / (4 pi^2), c = 5 / pi, r = 6, s = 10, t = 1 / (8 pi),
x1 in [-5, 10], x2 in [0, 15]; its global minimum 0.397887 lies at
(-pi, 12.275), (pi, 2.275) and (9.42478, 2.475)."""

import numpy as np

A, B, C = 1.0, 5.1 / (4.0 * np.pi ** 2), 5.0 / np.pi
R, S, T = 6.0, 10.0, 1.0 / (8.0 * np.pi)


def f(x):
    x1, x2 = x[:, 0], x[:, 1]
    return (A * (x2 - B * x1 * x1 + C * x1 - R) ** 2
            + S * (1.0 - T) * np.cos(x1) + S)
