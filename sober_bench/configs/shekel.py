"""The Shekel objective (m = 10, 4 dimensions, maximum 10.5364 at
(4, 4, 4, 4)): the user's black box of the `shekel` configuration, as the
reference defines it (SOBER experiments/_synthetic_function.py; the
configuration's source, examples/shekel.py). Plain numpy on the host."""
import numpy as np

BETA = 0.1 * np.array([1.0, 2.0, 2.0, 4.0, 4.0, 6.0, 3.0, 7.0, 5.0, 5.0])
C = np.array([[4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
              [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6],
              [4.0, 1.0, 8.0, 6.0, 3.0, 2.0, 5.0, 8.0, 6.0, 7.0],
              [4.0, 1.0, 8.0, 6.0, 7.0, 9.0, 3.0, 1.0, 2.0, 3.6]])


def objective(x: np.ndarray) -> np.ndarray:
    """Shekel at the rows of x (n, 4)."""
    x = np.atleast_2d(x)
    d2 = np.sum((x[:, :, None] - C[None]) ** 2, axis=1)
    return np.sum(1.0 / (d2 + BETA[None]), axis=1)
