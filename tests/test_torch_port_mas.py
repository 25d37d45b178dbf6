"""Monotonic alignment search in the port against tts_tpu, on the CPU.

``tts_tpu_torch.ops.mas.maximum_path`` on CPU tensors runs the plain version
(the CUDA kernel is held against it on the card in
``test_torch_port_cuda.py``). The path is 0/1, so every comparison is exact:
against ``maximum_path_jnp`` and ``maximum_path_pallas(interpret=True)``,
which compute in float32 with the same order of operations, on every case;
against the float64 numpy oracle only on well-separated values, where no
decision is a near-tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tts_tpu.ops.mas import maximum_path_jnp, maximum_path_numpy
from tts_tpu.ops.pallas.mas_kernel import maximum_path_pallas
from tts_tpu_torch.ops.mas import maximum_path


def _mask(t_xs, t_ys, T_x, T_y):
    m = np.zeros((len(t_xs), T_x, T_y), np.float32)
    for b, (tx, ty) in enumerate(zip(t_xs, t_ys)):
        m[b, :tx, :ty] = 1.0
    return m


def _ragged(seed):
    """B=3, T_x <= 17, T_y <= 40, lengths from the seed (t_x <= t_y)."""
    rng = np.random.default_rng(seed)
    T_x, T_y = 17, 40
    t_xs = rng.integers(1, T_x + 1, size=3)
    t_ys = np.maximum(t_xs, rng.integers(1, T_y + 1, size=3))
    t_xs[0], t_ys[0] = T_x, T_y            # one item fills the batch
    value = rng.standard_normal((3, T_x, T_y)).astype(np.float32)
    return value, _mask(t_xs, t_ys, T_x, T_y)


def _ties(seed):
    """Small integers: many exact ties between stay and diagonal."""
    rng = np.random.default_rng(seed)
    value = rng.integers(-2, 3, size=(3, 12, 30)).astype(np.float32)
    return value, _mask([12, 7, 5], [30, 19, 5], 12, 30)


def _square(seed):
    """T_y == T_x: the only path is the diagonal."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((2, 9, 9)).astype(np.float32)
    return value, _mask([9, 6], [9, 6], 9, 9)


def _one_symbol(seed):
    """T_x == 1: every frame on the one symbol."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((2, 1, 23)).astype(np.float32)
    return value, _mask([1, 1], [23, 11], 1, 23)


def _warp_edge(T_x, seed):
    """T_x = 31, 32, 33: around the 32 text rows of one warp's lanes in the
    card's kernel; T_y <= 80 keeps interpret mode quick."""
    rng = np.random.default_rng(seed)
    T_y = 80
    value = rng.standard_normal((2, T_x, T_y)).astype(np.float32)
    return value, _mask([T_x, T_x - 7], [T_y, 61], T_x, T_y)


def _zeroed_cell(seed):
    """Zeros inside the (t_x, t_y) rectangle, off its first row and column
    (which give the lengths): value is zeroed there and the path masked."""
    rng = np.random.default_rng(seed)
    value = rng.integers(-2, 3, size=(2, 12, 30)).astype(np.float32)
    mask = _mask([12, 9], [30, 25], 12, 30)
    mask[0, 3, 5] = mask[0, 4, 6] = mask[1, 2, 2] = 0.0
    mask[0, 11, 20:24] = 0.0
    return value, mask


CASES = {"ragged0": lambda: _ragged(0), "ragged1": lambda: _ragged(1),
         "ties": lambda: _ties(2), "square": lambda: _square(3),
         "one_symbol": lambda: _one_symbol(4),
         "warp31": lambda: _warp_edge(31, 7),
         "warp32": lambda: _warp_edge(32, 8),
         "warp33": lambda: _warp_edge(33, 9),
         "zeroed_cell": lambda: _zeroed_cell(10)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(value, mask):
    return maximum_path(torch.from_numpy(value),
                        torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("reference", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_path_equals_tts_tpu(case, reference):
    value, mask = CASES[case]()
    if reference == "jnp":
        want = maximum_path_jnp(jnp.asarray(value), jnp.asarray(mask))
    else:
        want = maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask),
                                   interpret=True)
    got = _port(value, mask)
    np.testing.assert_array_equal(got, np.asarray(want))
    # one active text position per valid frame, none outside the mask
    np.testing.assert_array_equal(got.sum(axis=1), mask[:, 0, :])
    assert got.dtype == np.float32


@pytest.mark.parametrize("seed", [5, 6])
def test_path_equals_numpy_oracle_on_separated_values(seed):
    """Integer values: every candidate sum is exact in float32 and float64,
    so two candidates either tie exactly or differ by at least 1, and the
    float64 oracle decides as the float32 DP does."""
    rng = np.random.default_rng(seed)
    T_x, T_y = 11, 33
    value = rng.integers(-9, 10, size=(3, T_x, T_y)).astype(np.float32)
    mask = _mask([11, 8, 4], [33, 20, 9], T_x, T_y)
    np.testing.assert_array_equal(_port(value, mask),
                                  maximum_path_numpy(value, mask))
