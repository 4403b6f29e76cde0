"""The port's Winograd kernel decomposition (paper Sec. 4.2.5) against the
reference's.

``decompose_kernel``, ``mult_reduction`` and ``winograd_conv2d_reference``
of ``repro_torch.core.winograd`` against ``repro.core.winograd``; the
port's ``kernels.winograd.winograd_conv2d`` (K3 per piece at its signed
offset, K2, one K4; on the CPU the kernels' plain versions) and
``hybrid_conv2d(mode="wino")`` on both port backends against the
reference's ``winograd_conv2d`` in Pallas interpret mode, at R x S in
{3x3, 5x5, 7x7, 5x3}, m in {2, 4}, SAME and VALID. Same seeded numpy
inputs into both packages; fp32 within ``rtol=atol=1e-4``, the
reference's own tolerance (``tests/test_backend_pallas.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import winograd as r_wino  # noqa: E402
from repro.kernels.winograd.ops import winograd_conv2d as r_wconv  # noqa: E402
from repro_torch.core import winograd as t_wino  # noqa: E402
from repro_torch.core.hybrid_conv import hybrid_conv2d  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.winograd import winograd_conv2d  # noqa: E402
from repro_torch.kernels.winograd.kernel import (  # noqa: E402
    wino_input_transform_nhwc_f32,
    wino_input_transform_nhwc_ref,
)

TOL = dict(rtol=1e-4, atol=1e-4)
KERNELS = [(3, 3), (5, 5), (7, 7), (5, 3)]
_REF: dict = {}


def _inputs(r, s, m, padding):
    rng = np.random.default_rng(r * 100 + s * 10 + m + (padding == "SAME"))
    x = rng.standard_normal((2, 9, 10, 3)).astype(np.float32)
    g = rng.standard_normal((r, s, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    return x, g, b


def _reference(r, s, m, padding):
    """The reference's Pallas ``winograd_conv2d`` (interpret mode) with
    bias and ReLU, once per case for both port backends."""
    key = (r, s, m, padding)
    if key not in _REF:
        x, g, b = _inputs(r, s, m, padding)
        _REF[key] = np.asarray(r_wconv(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), m=m,
            padding=padding, relu=True, interpret=True))
    return _REF[key]


@pytest.mark.parametrize("r,s", KERNELS)
@pytest.mark.parametrize("m", [2, 4])
def test_decompose_kernel_matches_reference(r, s, m):
    g = np.random.default_rng(r * s + m).standard_normal(
        (r, s, 3, 4)).astype(np.float32)
    ref = r_wino.decompose_kernel(jnp.asarray(g), m)
    port = t_wino.decompose_kernel(torch.from_numpy(g), m)
    assert [(oh, ow) for oh, ow, _ in port] == [(oh, ow) for oh, ow, _ in ref]
    for (_, _, a), (_, _, b) in zip(port, ref):
        assert tuple(a.shape) == (3, 3, 3, 4)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_mult_reduction_matches_reference():
    assert t_wino.mult_reduction(4) == r_wino.mult_reduction(4) == 4.0
    assert t_wino.mult_reduction(2) == r_wino.mult_reduction(2) == 2.25
    assert t_wino.mult_reduction(4, 5) == r_wino.mult_reduction(4, 5)


@pytest.mark.parametrize("r,s", KERNELS)
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("padding", ["SAME", "VALID",
                                     ((1, 2), (0, 3))], ids=str)
def test_winograd_conv2d_reference_matches_reference(r, s, m, padding):
    x, g, _ = _inputs(r, s, m, "SAME")
    y = t_wino.winograd_conv2d_reference(torch.from_numpy(x),
                                         torch.from_numpy(g), m, padding)
    y_ref = r_wino.winograd_conv2d_reference(jnp.asarray(x), jnp.asarray(g),
                                             m, padding)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)


@pytest.mark.parametrize("r,s", KERNELS)
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_decomposed_conv_matches_pallas(r, s, m, padding, backend):
    """hybrid_conv2d(mode="wino") on both port backends, and on hopper the
    standalone winograd_conv2d too, against the reference's Pallas path;
    the CPU wrappers launch nothing."""
    x, g, b = (torch.from_numpy(a) for a in _inputs(r, s, m, padding))
    y_ref = _reference(r, s, m, padding)
    common.reset_launches()
    y = hybrid_conv2d(x, g, b, mode="wino", m=m, padding=padding, relu=True,
                      backend=backend)
    assert tuple(y.shape) == y_ref.shape
    np.testing.assert_allclose(y.numpy(), y_ref, **TOL)
    if backend == "hopper":
        np.testing.assert_allclose(
            winograd_conv2d(x, g, b, m=m, padding=padding, relu=True,
                            dataflow="ws").numpy(), y_ref, **TOL)
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


@pytest.mark.parametrize("top,left", [(3, 3), (0, -3), (-6, 1), (-2, -4)])
def test_signed_offset_reads_the_shifted_window(top, left):
    """K3's NHWC front with an explicit grid and a signed offset: tile
    (th, tw) is x's window at (th m - top, tw m - left), zero outside x;
    the same tiles cut out of a zero-padded copy with numpy."""
    m, pt, (nh, nw) = 4, 6, (3, 2)
    x = np.random.default_rng(100 + top * 7 + left).standard_normal(
        (2, 9, 7, 5)).astype(np.float32)
    big = np.zeros((2, 40, 40, 5), np.float32)
    big[:, 20:29, 20:27] = x
    tiles = np.stack([big[n, 20 - top + th * m:20 - top + th * m + pt,
                          20 - left + tw * m:20 - left + tw * m + pt]
                      for n in range(2) for th in range(nh)
                      for tw in range(nw)])
    v_ref = np.asarray(r_wino.transform_input(
        jnp.asarray(tiles)[:, None, None], m))
    pads = ((top, 0), (left, 0))
    v = wino_input_transform_nhwc_f32(torch.from_numpy(x), m, pads, (nh, nw))
    np.testing.assert_allclose(v.numpy(), v_ref, **TOL)
    np.testing.assert_array_equal(
        v.numpy(), wino_input_transform_nhwc_ref(torch.from_numpy(x), m,
                                                 pads, (nh, nw)).numpy())


def test_negative_pads_need_a_grid():
    with pytest.raises(ValueError, match="without a grid"):
        wino_input_transform_nhwc_f32(torch.zeros(1, 8, 8, 2), 4,
                                      ((-3, 0), (0, 0)))
    with pytest.raises(ValueError, match="at least 1 x 1"):
        wino_input_transform_nhwc_f32(torch.zeros(1, 8, 8, 2), 4,
                                      ((0, 0), (0, 0)), (0, 2))
