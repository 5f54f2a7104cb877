"""Port parity: the y-order that kernel A (csrc/raster_setup.cu) now computes
with the rows, on the CPU.

The operator cosypose::raster_setup returns (rows, ykey, order). On the CPU
its order is sort_order (torch.sort, stable); on the card the kernel sorts
composite keys in shared memory, modelled in PyTorch by sort_composite_keys.
These tests hold, at small sizes:
  1. the operator's CPU order to sort_order on the demo spheres and on a soup
     with duplicated triangles, an all-invalid item and F % 8 != 0;
  2. sort_composite_keys to torch.sort(stable=True) on keys drawn by
     hypothesis: ties, +-0.0, +-inf, NaN, denormals and negative keys;
  3. the port's order to the JAX package's jnp.argsort(ykey, axis=1)
     (cosypose_tpu/ops/rasterizer_pallas.py:200) on the same keys, exactly,
     and the one place they part: XLA:CPU ties denormal keys with zero;
  4. the fake implementation's shapes and types.
All comparisons are exact: an order is a permutation, and equal keys keep
mesh order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cosypose_tpu_torch import demo
from cosypose_tpu_torch.ops import rasterizer_cuda as rc
from tests.test_torch_port_gpu import sliver_inputs, tie_soup

IMAGE = (48, 64)
INF, NAN = float("inf"), float("nan")
# keys that tie, sit on either side of zero, at the ends, or below the
# smallest normal float32
SPECIAL = [0.0, -0.0, INF, -INF, NAN, 1e-40, -1e-40, 1e-45, -1e-45, 1.0, -1.0, 12.5, -3.25,
           1.17549435e-38, -1.17549435e-38, 3.4e38]


def spheres():
    """The demo spheres at crop poses: (tri_verts, tri_valid, TCO, K, colors)."""
    first = demo.first_render_inputs(4, (480, 640), IMAGE, 64, "cpu")
    return first["tri_verts"], first["tri_valid"], first["TCO"], first["K_crop"], first["colors"]


def slivers():
    tv, valid, TCO, K = (torch.as_tensor(a) for a in sliver_inputs())
    return tv, valid, TCO, K, None


SOUPS = {"spheres": spheres, "tie soup": tie_soup, "slivers": slivers}


def jax_order(key: torch.Tensor) -> np.ndarray:
    """The JAX package's order of these keys: rasterizer_pallas.py:200."""
    return np.asarray(jnp.argsort(jnp.asarray(key.numpy()), axis=1))


def op_outputs(soup):
    tv, valid, TCO, K, colors = SOUPS[soup]()
    image = (240, 320) if soup == "slivers" else IMAGE
    return rc.raster_setup_op(tv, valid, TCO, K, list(image), colors, 0.05, None)


@pytest.mark.parametrize("soup", ["spheres", "tie soup"])
def test_operator_order_on_the_cpu_is_sort_order(soup):
    rows, key, order = op_outputs(soup)
    assert order.dtype == torch.int64 and order.shape == key.shape
    assert torch.equal(order, rc.sort_order(key))
    assert torch.equal(order, rc.sort_composite_keys(key))
    srt = torch.gather(key, 1, order)
    assert bool((srt[:, 1:] >= srt[:, :-1]).all())
    ties = srt[:, 1:] == srt[:, :-1]
    assert bool((order[:, 1:] > order[:, :-1])[ties].all())   # equal keys in mesh order
    if soup == "tie soup":
        assert key.shape[1] == 48 and bool(ties.any()) and bool((key < 0).any())
        assert torch.equal(order[1], torch.arange(48))         # all invalid: mesh order
        assert bool(torch.isinf(key[:, 45:]).all())             # padding rows


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.lists(st.one_of(st.sampled_from(SPECIAL),
                                   st.floats(width=32, allow_nan=False)),
                         min_size=12, max_size=12),
                min_size=1, max_size=4),
       st.integers(0, 11))
def test_composite_keys_order_as_torch_sort(rows, n_ties):
    """The kernel's key map and composites, in PyTorch, against
    torch.sort(stable=True): float32 keys drawn from the special values and
    from all finite floats, with a run of copies of the first key."""
    keys = torch.tensor(rows, dtype=torch.float32)
    keys[:, 12 - n_ties:] = keys[:, :1]
    assert torch.equal(rc.sort_composite_keys(keys), torch.sort(keys, dim=1, stable=True).indices)


def test_composite_keys_order_nan_by_its_bits():
    """A NaN orders by its bits, as torch.sort does on the card: a positive
    one above +inf, a negative one below -inf (PyTorch on the CPU puts every
    NaN last; the kernel's own NaNs are positive)."""
    bits = torch.tensor([0x7FC00000, -4194304, 0xFF800000 - 2 ** 32, 0x7F800000, 0],
                        dtype=torch.int64).to(torch.int32)
    keys = bits.view(torch.float32)[None]
    assert rc.sort_composite_keys(keys).tolist() == [[1, 2, 4, 3, 0]]
    assert torch.sort(keys, dim=1, stable=True).indices.tolist() == [[2, 4, 3, 0, 1]]


@pytest.mark.parametrize("soup", ["spheres", "slivers"])
def test_order_equals_jax_argsort_on_setup_keys(soup):
    _, key, order = op_outputs(soup)
    np.testing.assert_array_equal(order.numpy(), jax_order(key))
    np.testing.assert_array_equal(rc.sort_composite_keys(key).numpy(), jax_order(key))


@settings(max_examples=100, deadline=None, database=None)
@given(st.lists(st.lists(st.sampled_from([0.0, -0.0, INF, NAN, 1.0, -1.0, 2.5, -7.0, 3e5]),
                         min_size=16, max_size=16), min_size=1, max_size=3))
def test_order_equals_jax_argsort_on_drawn_keys(rows):
    """Ties, +-0.0, +inf and NaN: the port's order and the JAX package's
    argsort agree exactly."""
    keys = torch.tensor(rows, dtype=torch.float32)
    want = jax_order(keys)
    np.testing.assert_array_equal(rc.sort_composite_keys(keys).numpy(), want)
    np.testing.assert_array_equal(rc.sort_order(keys).numpy(), want)


def test_denormal_keys_divergence_from_jax_is_documented():
    """XLA:CPU's argsort ties denormal keys with zero (flush to zero in its
    comparator); the port orders them by value, as torch.sort does on the
    card and on the CPU (ROADMAP §3). A y-centre in pixels does not fall in
    (0, 1.2e-38) in practice."""
    keys = torch.tensor([[1e-40, 0.0, -1e-40, -0.0]])
    assert jax_order(keys).tolist() == [[0, 1, 2, 3]]
    assert rc.sort_composite_keys(keys).tolist() == [[2, 1, 3, 0]]
    assert rc.sort_order(keys).tolist() == [[2, 1, 3, 0]]


@pytest.mark.parametrize("F", [45, 48])
def test_setup_fake_shapes_and_types(F):
    from torch._subclasses.fake_tensor import FakeTensorMode

    tv, valid, TCO, K, colors = tie_soup(F=F)
    real = rc.raster_setup_op(tv, valid, TCO, K, list(IMAGE), colors, 0.05, None)
    with FakeTensorMode() as mode:
        fake = rc.raster_setup_op(*(mode.from_tensor(a) for a in (tv, valid, TCO, K)),
                                  list(IMAGE), mode.from_tensor(colors), 0.05, None)
    assert [(f.shape, f.dtype) for f in fake] == [(r.shape, r.dtype) for r in real] == [
        ((3, 48, rc.ROW), torch.float32), ((3, 48), torch.float32), ((3, 48), torch.int64)]
