"""The port's kernel wrappers against the reference's Pallas ops (interpret
mode on the CPU).

On the CPU every ``hopper`` wrapper runs its kernel's plain version, so
these cases exercise the wrappers' im2col, tiling, pad and crop arithmetic;
``test_torch_gpu.py`` holds the CUDA kernels against the plain versions on
a card.
Tolerance: ``rtol=atol=1e-4``, the reference's own fp32 budget; for K6
(flash attention) the reference's own attention budgets, ``rtol=atol=2e-4``
in fp32 and ``3e-2`` in bf16 (``tests/test_kernels_attention.py``).
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import winograd as r_wino  # noqa: E402
from repro.kernels.flash_attention import flash_attention as r_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.kernels.gemm import batched_matmul as r_batched_matmul  # noqa: E402
from repro.kernels.gemm import matmul as r_matmul  # noqa: E402
from repro.kernels.gemm.kernel import batched_matmul_kernel  # noqa: E402
from repro.kernels.spatial_conv import spatial_conv2d as r_spatial  # noqa: E402
from repro.kernels.winograd import input_transform as r_input_tf  # noqa: E402
from repro.kernels.winograd import output_transform as r_output_tf  # noqa: E402
from repro.kernels.winograd import (  # noqa: E402
    winograd_apply_pretransformed_pallas as r_wino_apply,
)
from repro.kernels.winograd.kernel import (  # noqa: E402
    input_transform_kernel as r_input_kernel,
)
from repro.kernels.winograd.ops import (  # noqa: E402
    _finish_output as r_finish_output,
)
from repro.models import layers as r_layers  # noqa: E402
from repro_torch.core import winograd as t_wino  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.kernels.gemm import batched_matmul, matmul  # noqa: E402
from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref  # noqa: E402
from repro_torch.kernels.gemm.ref import batched_matmul_ref  # noqa: E402
from repro_torch.core.hybrid_conv import explicit_pads  # noqa: E402
from repro_torch.kernels.spatial_conv import ops as conv_ops  # noqa: E402
from repro_torch.kernels.spatial_conv import spatial_conv2d  # noqa: E402
from repro_torch.kernels.spatial_conv.kernel import (  # noqa: E402
    conv_gemm_f32,
    conv_gemm_ref,
    conv_implicit_f32,
    conv_implicit_ref,
    takes_implicit,
)
from repro_torch.kernels.spatial_conv.ref import spatial_conv2d_ref  # noqa: E402
from repro_torch.kernels.winograd import (  # noqa: E402
    input_transform,
    output_transform,
    winograd_apply_pretransformed_hopper,
)
from repro_torch.kernels.winograd.kernel import (  # noqa: E402
    wino_grid,
    wino_input_transform_f32,
    wino_input_transform_nhwc_f32,
    wino_input_transform_nhwc_ref,
    wino_input_transform_ref,
    wino_output_transform_f32,
    wino_output_transform_nhwc_f32,
    wino_output_transform_nhwc_ref,
    wino_output_transform_ref,
)
from repro_torch.kernels.winograd.ref import conv2d_ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(t_out, r_out, **tol):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(r_out),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# K1: spatial convolution (im2col + conv_gemm_f32)
# ---------------------------------------------------------------------------

CONV_CASES = [
    # (h, w, c, k, r, stride, padding, relu)
    (9, 9, 3, 8, 3, 1, "SAME", True),
    (9, 9, 3, 8, 3, 1, "VALID", False),
    (10, 10, 5, 7, 3, 2, "SAME", True),      # strided SAME: asymmetric pads
    (11, 8, 4, 6, 3, 2, "VALID", False),
    (8, 8, 4, 6, 3, 1, ((0, 0), (1, 1)), True),   # executor's explicit pads
    (7, 9, 3, 5, 3, 1, ((1, 2), (0, 1)), False),  # asymmetric explicit pads
    (12, 12, 6, 4, 1, 2, "SAME", False),     # 1x1 projection, stride 2
]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_spatial_conv2d_matches_pallas(case):
    h, w, c, k, r, stride, padding, relu = case
    rng = np.random.default_rng(h * 100 + c)
    x, g, b = _np(rng, 2, h, w, c), _np(rng, r, r, c, k), _np(rng, k)
    y_ref = r_spatial(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                      stride=stride, padding=padding, relu=relu)
    y = spatial_conv2d(torch.from_numpy(x), torch.from_numpy(g),
                       torch.from_numpy(b), stride=stride, padding=padding,
                       relu=relu)
    _close(y, y_ref)
    _close(spatial_conv2d_ref(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(b), stride=stride,
                              padding=padding, relu=relu), y_ref)


def test_conv_gemm_plain_version_matches_pallas_kernel():
    """conv_gemm_ref (the CPU path of K1) against the reference kernel body
    at block-multiple shapes, with the fused bias + ReLU epilogue."""
    from repro.kernels.spatial_conv.kernel import conv_gemm_kernel
    rng = np.random.default_rng(1)
    p, w, b = _np(rng, 16, 128), _np(rng, 128, 128), _np(rng, 128)
    for relu, df in [(True, "is"), (False, "ws")]:
        y_ref = conv_gemm_kernel(jnp.asarray(p), jnp.asarray(w),
                                 jnp.asarray(b), bm=8, bn=128, bk=128,
                                 dataflow=df, relu=relu)
        args = [torch.from_numpy(a) for a in (p, w, b)]
        _close(conv_gemm_ref(*args, relu, df), y_ref)
        _close(conv_gemm_f32(*args, relu, df), y_ref)


# K1 over the map itself: (h, w, c, k, r, stride, padding) with C and K in
# fours and N*HO*WO >= 64 at batch 2, each on a contiguous map and on a row
# slab of a taller one (a strided view, as the blocked lowering hands it)
IMPLICIT_CASES = [
    (9, 9, 4, 8, 3, 1, "SAME"),
    (12, 12, 8, 8, 3, 2, "SAME"),             # strided SAME: pads (0, 1)
    (14, 14, 8, 12, 1, 2, "SAME"),            # 1x1 projection, stride 2
    (9, 11, 4, 8, 3, 1, ((1, 2), (0, 1))),    # asymmetric explicit pads
    (8, 8, 4, 8, 3, 1, ((0, 0), (1, 1))),     # a row slab's width pads
]


def _spy(monkeypatch, *names):
    """Count the calls ``spatial_conv2d`` makes to each K1 entry."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def call(*a, _name=name, _fn=getattr(conv_ops, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(conv_ops, name, call)
    return calls


@pytest.mark.parametrize("view", [False, True], ids=["map", "row_slab"])
@pytest.mark.parametrize("case", IMPLICIT_CASES, ids=str)
def test_spatial_conv2d_reads_the_map_where_it_can(case, view, monkeypatch):
    """Where the rule holds, ``spatial_conv2d`` hands K1 the map as it lies
    (``conv_implicit_f32``, whose plain version is ``im2col`` then
    ``conv_gemm_ref``), equal to the reference's Pallas conv and to the
    direct conv."""
    h, w, c, k, r, stride, padding = case
    rng = np.random.default_rng(h * 100 + c + view)
    x = torch.from_numpy(_np(rng, 2, h + 3 * view, w, c))[:, 2 * view:][
        :, :h]
    g, b = (torch.from_numpy(_np(rng, *s)) for s in ((r, r, c, k), (k,)))
    assert x.is_contiguous() != view
    pads = explicit_pads(padding, h, w, r, r, stride)
    assert takes_implicit(x, g, stride, pads)
    calls = _spy(monkeypatch, "conv_implicit_f32", "conv_gemm_f32")
    y = spatial_conv2d(x, g, b, stride=stride, padding=padding, relu=True)
    assert calls == {"conv_implicit_f32": 1, "conv_gemm_f32": 0}
    assert torch.equal(y, conv_implicit_ref(x, g, b, stride=stride,
                                            pads=pads, relu=True))
    _close(y, r_spatial(jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
                        jnp.asarray(b.numpy()), stride=stride,
                        padding=padding, relu=True))
    _close(y, spatial_conv2d_ref(x, g, b, stride=stride, padding=padding,
                                 relu=True).numpy())


def _misaligned_map(n, h, w, c):
    """A contiguous map whose data pointer is 4 bytes off a 16-byte
    boundary."""
    return torch.randn(n * h * w * c + 1)[1:].view(n, h, w, c)


# (label, map, weights, stride, pads, implicit?): which shapes K1 reads in
# place and which keep im2col's patches
ROUTE_CASES = [
    ("c4_k8", lambda: torch.randn(2, 8, 8, 4), (3, 3, 4, 8), 1,
     ((1, 1), (1, 1)), True),
    ("channel_slice", lambda: torch.randn(2, 8, 8, 12)[..., 4:8],
     (3, 3, 4, 8), 1, ((1, 1), (1, 1)), True),
    ("first_conv_c3", lambda: torch.randn(2, 8, 8, 3), (3, 3, 3, 8), 1,
     ((1, 1), (1, 1)), False),
    ("k6", lambda: torch.randn(2, 8, 8, 4), (3, 3, 4, 6), 1,
     ((1, 1), (1, 1)), False),
    ("m_below_64", lambda: torch.randn(1, 7, 7, 4), (3, 3, 4, 8), 1,
     ((1, 1), (1, 1)), False),
    ("misaligned", lambda: _misaligned_map(2, 8, 8, 4), (3, 3, 4, 8), 1,
     ((1, 1), (1, 1)), False),
    ("channels_strided", lambda: torch.randn(2, 8, 8, 8)[..., ::2],
     (3, 3, 4, 8), 1, ((1, 1), (1, 1)), False),
    ("row_stride_off_4", lambda: torch.randn(2 * 8 * 9 * 4 + 32).as_strided(
        (2, 8, 8, 4), (8 * 9 * 4 + 2, 9 * 4 + 2, 4, 1)), (3, 3, 4, 8), 1,
     ((1, 1), (1, 1)), False),
    ("negative_pad", lambda: torch.randn(2, 10, 10, 4), (3, 3, 4, 8), 1,
     ((-1, 0), (1, 1)), False),
]


@pytest.mark.parametrize("case", ROUTE_CASES, ids=lambda c: c[0])
def test_k1_route_by_shape_and_alignment(case, monkeypatch):
    """``takes_implicit`` decides by shape, layout and alignment alone, and
    ``spatial_conv2d`` launches exactly that entry; either way it equals
    the direct conv. ``conv_implicit_f32`` itself refuses what the rule
    refuses."""
    _, make, wshape, stride, pads, implicit = case
    x, g = make(), torch.randn(*wshape)
    assert takes_implicit(x, g, stride, pads) is implicit
    calls = _spy(monkeypatch, "conv_implicit_f32", "conv_gemm_f32")
    y = spatial_conv2d(x, g, None, stride=stride, padding=pads)
    assert calls == {"conv_implicit_f32": int(implicit),
                     "conv_gemm_f32": int(not implicit)}
    if min(min(p) for p in pads) >= 0:
        _close(y, spatial_conv2d_ref(x, g, stride=stride,
                                     padding=pads).numpy())
    if not implicit:
        with pytest.raises(ValueError, match="takes_implicit"):
            conv_implicit_f32(x, g, stride=stride, pads=pads)


@pytest.mark.parametrize("entry,c", [("conv_implicit_f32", 4),
                                     ("conv_gemm_f32", 3)])
def test_k1_ops_export(entry, c):
    """``torch.export`` traces ``spatial_conv2d`` through the K1 entry its
    rule picks, as a ``torch.ops.repro_torch`` op (a row slab of a taller
    map stays a view: a slice, no copy), and the exported program answers
    as the eager call; ``opcheck`` passes on the op."""
    class Conv(torch.nn.Module):
        def forward(self, x, g, b):
            return spatial_conv2d(x[:, 1:9], g, b,
                                  padding=((0, 0), (1, 1)), relu=True)

    x, g, b = torch.randn(2, 10, 9, c), torch.randn(3, 3, c, 8), \
        torch.randn(8)
    ep = torch.export.export(Conv(), (x, g, b))
    ops = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert f"repro_torch.{entry}.default" in ops
    assert torch.equal(ep.module()(x, g, b), Conv()(x, g, b))
    if entry == "conv_implicit_f32":
        assert ops == {"aten.slice.Tensor", f"repro_torch.{entry}.default"}
        args = (x[:, 1:9], g, b, 1, [0, 0, 1, 1], True, False)
    else:
        args = (torch.randn(48, 27), torch.randn(27, 8), b, True, False)
    torch.library.opcheck(getattr(torch.ops.repro_torch, entry).default,
                          args)


# ---------------------------------------------------------------------------
# K2: batched GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,m,k,n", [(1, 16, 32, 24), (36, 20, 17, 9),
                                     (1, 8, 300, 70), (36, 64, 64, 128)])
@pytest.mark.parametrize("dataflow", ["is", "ws"])
def test_batched_matmul_matches_pallas(g, m, k, n, dataflow):
    rng = np.random.default_rng(g + m + k + n)
    a, b = _np(rng, g, m, k), _np(rng, g, k, n)
    y_ref = r_batched_matmul(jnp.asarray(a), jnp.asarray(b), dataflow=dataflow)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(batched_matmul(ta, tb, dataflow=dataflow), y_ref)
    _close(batched_matmul_ref(ta, tb), y_ref)
    if g == 1:
        _close(matmul(ta[0], tb[0]),
               r_matmul(jnp.asarray(a[0]), jnp.asarray(b[0])))


@pytest.mark.parametrize("g", [1, 36])
@pytest.mark.parametrize("relu", [False, True])
def test_bmm_bias_relu_matches_pallas_epilogue(g, relu):
    rng = np.random.default_rng(g)
    a, b, bias = _np(rng, g, 16, 128), _np(rng, g, 128, 128), _np(rng, g, 128)
    y_ref = batched_matmul_kernel(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(bias), bm=8, bn=128, bk=128,
                                  relu=relu)
    args = [torch.from_numpy(x) for x in (a, b, bias)]
    _close(bmm_ref(*args, relu), y_ref)
    _close(bmm_f32(*args, relu), y_ref)


# ---------------------------------------------------------------------------
# K3 / K4: Winograd transforms and the pretransformed Winograd PE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("t,c,k", [(13, 11, 10), (6, 64, 8)])
def test_winograd_transforms_match_pallas(m, t, c, k):
    pt = m + 2
    rng = np.random.default_rng(m)
    tiles = _np(rng, t, pt, pt, c)
    _close(input_transform(torch.from_numpy(tiles), m),
           r_input_tf(jnp.asarray(tiles), m))
    _close(wino_input_transform_ref(torch.from_numpy(tiles), m),
           r_input_tf(jnp.asarray(tiles), m))
    mm, bias = _np(rng, pt * pt, t, k), _np(rng, k)
    for relu in (False, True):
        y_ref = r_output_tf(jnp.asarray(mm), jnp.asarray(bias), m, relu=relu)
        _close(output_transform(torch.from_numpy(mm),
                                torch.from_numpy(bias), m, relu), y_ref)
        _close(wino_output_transform_ref(torch.from_numpy(mm),
                                         torch.from_numpy(bias), m, relu),
               y_ref)


# SAME, VALID, the executor's width-only pad (the slab carries the vertical
# one) and odd explicit pads
WINO_PADDINGS = ["SAME", "VALID", ((0, 0), (1, 1)), ((1, 2), (0, 1))]


def _explicit(padding):
    return {"SAME": ((1, 1), (1, 1)), "VALID": ((0, 0), (0, 0))}.get(
        padding, padding) if isinstance(padding, str) else padding


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("padding", WINO_PADDINGS, ids=str)
@pytest.mark.parametrize("relu", [False, True])
def test_winograd_pretransformed_matches_pallas(m, padding, relu):
    rng = np.random.default_rng(m * 10 + relu)
    x, g, b = _np(rng, 2, 10, 11, 5), _np(rng, 3, 3, 5, 6), _np(rng, 6)
    u = r_wino.transform_weights(jnp.asarray(g), m)
    # the reference takes SAME/VALID: explicit pads go in as a padded input
    (top, bottom), (left, right) = _explicit(padding)
    x_ref = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)))
    y_ref = r_wino_apply(jnp.asarray(x_ref), u, jnp.asarray(b), m=m,
                         padding="VALID", relu=relu)
    if isinstance(padding, str):
        np.testing.assert_allclose(np.asarray(y_ref), np.asarray(r_wino_apply(
            jnp.asarray(x), u, jnp.asarray(b), m=m, padding=padding,
            relu=relu)), **TOL)
    t_u = t_wino.transform_weights(torch.from_numpy(g), m)
    np.testing.assert_allclose(t_u.numpy(), np.asarray(u), **TOL)
    y = winograd_apply_pretransformed_hopper(
        torch.from_numpy(x), t_u, torch.from_numpy(b), m=m, padding=padding,
        relu=relu)
    _close(y, y_ref)
    # the torch backend's Winograd PE and the direct conv agree too
    x_t, pad_t = ((x, padding) if isinstance(padding, str)
                  else (x_ref, "VALID"))
    _close(t_wino.winograd_apply_pretransformed(
        torch.from_numpy(x_t), t_u, torch.from_numpy(b), m, relu=relu,
        padding=pad_t), y_ref)
    _close(conv2d_ref(torch.from_numpy(x), torch.from_numpy(g),
                      _explicit(padding), torch.from_numpy(b), relu), y_ref)


def _reference_nhwc_fronts(x, mm, bias, m, padding, relu):
    """The reference's side of K3's and K4's NHWC fronts: its tile_input
    on the padded input, then input_transform_kernel (interpret mode); its
    output_transform_kernel, then _finish_output's reshape, transpose and
    crop."""
    (top, bottom), (left, right) = _explicit(padding)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (top, bottom), (left, right),
                                  (0, 0)))
    tiles, (nh, nw) = r_wino.tile_input(xp, m)
    n, c, pt = x.shape[0], x.shape[3], m + 2
    t = n * nh * nw
    v = r_input_kernel(tiles.reshape(t, pt, pt, c), m=m, bt=t, bc=c,
                       interpret=True)
    ho, wo = xp.shape[1] - 2, xp.shape[2] - 2
    k = mm.shape[2]
    y = r_finish_output(jnp.asarray(mm), jnp.asarray(bias), m=m, bt=t, bk=k,
                        relu=relu, interpret=True, geom=(n, nh, nw, t, t),
                        ho=ho, wo=wo, k=k, kp=k, out_dtype=jnp.float32)
    return v, y, (ho, wo, nh, nw)


def _check_nhwc_fronts(n, h, w, c, k, m, padding, relu, seed):
    rng = np.random.default_rng(seed)
    pad = _explicit(padding)
    ho, wo, nh, nw = wino_grid(h, w, m, pad)
    x = _np(rng, n, h, w, c)
    mm, bias = _np(rng, (m + 2) ** 2, n * nh * nw, k), _np(rng, k)
    v_ref, y_ref, grid = _reference_nhwc_fronts(x, mm, bias, m, padding, relu)
    assert grid == (ho, wo, nh, nw)
    tx, tm, tb = (torch.from_numpy(a) for a in (x, mm, bias))
    _close(wino_input_transform_nhwc_f32(tx, m, pad), v_ref)
    _close(wino_input_transform_nhwc_ref(tx, m, pad), v_ref)
    _close(wino_output_transform_nhwc_f32(tm, tb, m, (n, ho, wo), relu),
           y_ref)
    _close(wino_output_transform_nhwc_ref(tm, tb, m, (n, ho, wo), relu),
           y_ref)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("padding", WINO_PADDINGS, ids=str)
def test_winograd_nhwc_fronts_match_pallas(m, padding):
    """K3's and K4's NHWC fronts (on the CPU, their plain versions)
    against the reference's tile gather, kernels and scatter/crop, at a
    ragged size (Ho, Wo not multiples of m under most pads)."""
    _check_nhwc_fronts(2, 10, 11, 5, 6, m, padding, relu=m == 4, seed=m)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:       # hypothesis is optional, as in test_properties.py
    given = None

if given is not None:
    @settings(max_examples=12, deadline=None)
    @given(n=st.integers(1, 2), h=st.integers(1, 9), w=st.integers(1, 9),
           c=st.integers(1, 6), k=st.integers(1, 5), m=st.sampled_from([2, 4]),
           padding=st.sampled_from(WINO_PADDINGS), relu=st.booleans())
    def test_winograd_nhwc_fronts_property(n, h, w, c, k, m, padding, relu):
        """Any small geometry the padded input covers with a 3x3 kernel,
        Ho and Wo multiples of m or not."""
        (top, bottom), (left, right) = _explicit(padding)
        if h + top + bottom < 3 or w + left + right < 3:
            return
        _check_nhwc_fronts(n, h, w, c, k, m, padding, relu, seed=h * w + c)


def test_hopper_winograd_pe_copies_nothing_in_between():
    """x -> K3 -> K2 -> K4 -> y: the PE itself gathers, pads, permutes
    and crops nothing (its kernels read and write the NHWC images)."""
    src = inspect.getsource(winograd_apply_pretransformed_hopper)
    body = src[src.index('"""', src.index('"""') + 3):]
    for word in ("tile_input", "pad_for_conv", "F.pad", "permute", "[:,"):
        assert word not in body, word


def test_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(2, 3, 4)
    with pytest.raises(TypeError, match="float32"):
        bmm_f32(a.double(), torch.zeros(2, 4, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        bmm_f32(a, torch.zeros(2, 5, 4).transpose(1, 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        bmm_f32(a, torch.zeros(2, 5, 5))
    with pytest.raises(ValueError, match="m must be"):
        wino_input_transform_f32(torch.zeros(1, 5, 5, 2), 3)
    with pytest.raises(ValueError, match="smaller than"):
        wino_input_transform_nhwc_f32(torch.zeros(1, 2, 5, 2), 4)
    with pytest.raises(ValueError, match="takes 8"):
        wino_output_transform_nhwc_f32(torch.zeros(36, 7, 2), None, 4,
                                       (2, 8, 8))
    with pytest.raises(ValueError, match="meta"):
        conv_gemm_f32(torch.zeros(2, 3, device="meta"),
                      torch.zeros(3, 4, device="meta"))


def test_cpu_wrappers_launch_no_kernel():
    common.reset_launches()
    x = torch.randn(1, 6, 6, 3)
    spatial_conv2d(x, torch.randn(3, 3, 3, 4))
    winograd_apply_pretransformed_hopper(x, torch.randn(6, 6, 3, 4), m=4)
    matmul(torch.randn(2, 3), torch.randn(3, 4))
    flash_attention(*(torch.randn(1, 2, 5, 8) for _ in range(3)))
    assert common.LAUNCHES == dict.fromkeys(common.KERNELS, 0)


# ---------------------------------------------------------------------------
# K5: int8 GEMM with the fused requantize epilogue (bit for bit)
# ---------------------------------------------------------------------------

def _i8(rng, *shape):
    return rng.integers(-127, 128, size=shape, dtype=np.int8)


@pytest.mark.parametrize("m,k,n", [(8, 27, 10), (33, 27, 1000),
                                   (100, 4608, 10), (8, 4608, 1000),
                                   # shapes of the tensor-core route: a K
                                   # tail short of its 128-byte slab,
                                   # ragged M, N 64 and ragged N past 128
                                   (200, 576, 64), (130, 144, 144)])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_qmm_plain_version_matches_pallas_bitwise(m, k, n, per_channel, relu):
    from repro.kernels.gemm.int8 import quantized_matmul as r_qmm

    from repro_torch.kernels.gemm.int8 import quantized_matmul
    rng = np.random.default_rng(m * k + n + per_channel)
    a, b = _i8(rng, m, k), _i8(rng, k, n)
    bias = rng.integers(-20000, 20000, size=n, dtype=np.int32)
    mult = (rng.random(n).astype(np.float32) * np.float32(2e-4)
            if per_channel else 7.3e-5)
    y_ref = np.asarray(r_qmm(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(bias), mult=mult, relu=relu,
                             interpret=True))
    y = quantized_matmul(torch.from_numpy(a), torch.from_numpy(b),
                         torch.from_numpy(bias), mult=mult, relu=relu)
    assert y.dtype == torch.int8
    np.testing.assert_array_equal(y.numpy(), y_ref)


def test_qmm_rounds_accumulators_above_2_24_like_pallas():
    """|acc| up to 4608 * 127**2 ~ 7.4e7 > 2**24: the int32 -> float32
    conversion rounds, identically in both packages."""
    from repro.kernels.gemm.int8 import quantized_matmul as r_qmm

    from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref
    k, n = 4608, 12
    a = np.full((9, k), 127, np.int8)
    a[1::2] = -127
    b = np.full((k, n), 127, np.int8)
    b[:, ::3] = -126
    bias = np.arange(n, dtype=np.int32) * 7 + 1
    mult = np.linspace(1e-6, 2e-6, n, dtype=np.float32)
    y_ref = np.asarray(r_qmm(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(bias), mult=mult, interpret=True))
    args = [torch.from_numpy(x) for x in (a, b, bias, mult)]
    assert np.abs(a.astype(np.int64) @ b.astype(np.int64)).max() > 2 ** 24
    np.testing.assert_array_equal(qmm_ref(*args).numpy(), y_ref)
    np.testing.assert_array_equal(qmm_i8(*args).numpy(), y_ref)


def test_qmm_wrapper_checks_operand_types():
    from repro_torch.kernels.gemm.int8 import qmm_i8, quantized_matmul
    a, b = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3,
                                                            dtype=torch.int8)
    bias, mult = torch.zeros(3, dtype=torch.int32), torch.ones(3)
    with pytest.raises(TypeError, match="int32"):
        qmm_i8(a, b, bias.float(), mult)
    with pytest.raises(TypeError, match="float32"):
        qmm_i8(a, b, bias, mult.double())
    with pytest.raises(TypeError, match="int8"):
        quantized_matmul(a.float(), b, bias, mult=1.0)
    with pytest.raises(ValueError, match="shape mismatch"):
        qmm_i8(a, b[:5], bias, mult)
    with pytest.raises(ValueError, match="mult"):
        quantized_matmul(a, b, bias, mult=np.ones(4, np.float32))
    common.reset_launches()
    assert quantized_matmul(a, b, bias, mult=0.5).shape == (4, 3)
    assert common.LAUNCHES["qmm_i8"] == 0       # CPU: the plain version


def test_on_cpu_checks_each_operands_dtype():
    """The shared operand check takes one dtype per operand (a repair: it
    accepted float32 only, so K5's int8/int32 operands could not pass)."""
    i8 = torch.zeros(2, dtype=torch.int8)
    f32 = torch.zeros(2)
    assert common.on_cpu("k", i8, f32, dtypes=(torch.int8, torch.float32))
    assert common.on_cpu("k", f32, None, f32)
    with pytest.raises(TypeError, match="expected int8"):
        common.on_cpu("k", f32, f32, dtypes=(torch.int8, torch.float32))
    with pytest.raises(ValueError, match="dtypes"):
        common.on_cpu("k", f32, dtypes=(torch.float32, torch.float32))


# ---------------------------------------------------------------------------
# K6: flash attention (top-left causal mask, kv_len mask, GQA in place)
# ---------------------------------------------------------------------------

FA_CASES = [
    # (b, h, hkv, sq, skv, d)
    (1, 2, 2, 64, 64, 32),
    (2, 4, 2, 40, 72, 16),       # Sq < Skv: where ref.py and the kernel differ
    (1, 8, 2, 100, 100, 32),     # GQA 4, ragged
    (2, 4, 1, 37, 53, 64),       # GQA 4, ragged Sq < Skv
    (1, 4, 4, 70, 45, 24),       # Sq > Skv
]


def _qkv(rng, b, h, hkv, sq, skv, d, dtype=np.float32):
    q = rng.standard_normal((b, h, sq, d)).astype(dtype)
    k = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    v = rng.standard_normal((b, hkv, skv, d)).astype(dtype)
    return q, k, v


@pytest.mark.parametrize("case", FA_CASES, ids=str)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_kernel(case, causal):
    rng = np.random.default_rng(sum(case))
    q, k, v = _qkv(rng, *case)
    ref = r_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, bq=32, bk=32, interpret=True)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("sq,skv", [(128, 128), (40, 72)])
def test_flash_attention_bf16_matches_pallas_kernel(sq, skv):
    rng = np.random.default_rng(sq + skv)
    q, k, v = _qkv(rng, 1, 4, 2, sq, skv, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = np.asarray(r_flash(jq, jk, jv, bq=64, bk=64, interpret=True),
                     np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (jq, jk, jv))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=3e-2,
                               atol=3e-2)


def test_plain_version_is_top_left_causal_unlike_attention_ref():
    """Sq == Skv: the port's plain version equals the reference oracle.
    Sq < Skv: it follows the kernel's top-left mask, and the oracle's
    bottom-right mask gives another result."""
    rng = np.random.default_rng(3)
    for sq, skv, same in ((48, 48, True), (40, 72, False)):
        q, k, v = (a[0] for a in _qkv(rng, 1, 2, 2, sq, skv, 16))
        oracle = np.asarray(attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v)))
        out = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
        mask = np.tril(np.ones((sq, skv), bool))     # top left: col <= row
        s = np.einsum("bqd,bkd->bqk", q, k) * 16 ** -0.5
        s = np.where(mask, s, -1e30)
        p = np.exp(s - s.max(-1, keepdims=True))
        top_left = np.einsum("bqk,bkd->bqd", p / p.sum(-1, keepdims=True), v)
        np.testing.assert_allclose(out.numpy(), top_left, rtol=2e-4,
                                   atol=2e-4)
        assert np.allclose(out.numpy(), oracle, atol=2e-4) == same


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("row_offset", [0, 5, 40])
def test_plain_version_with_row_offset_matches_reference_scan(row_offset,
                                                              causal):
    """The causal mask shifted by ``row_offset`` (a chunk whose first
    position is ``row_offset``) against the reference's scan-flash, in its
    grouped layout; non-causal calls ignore the offset."""
    rng = np.random.default_rng(11 + row_offset)
    b, s, g, r, d, skv = 2, 24, 2, 2, 16, 70
    qg = rng.standard_normal((b, s, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, g, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, g, d)).astype(np.float32)
    ref = r_layers._flash_attention_scan(
        jnp.asarray(qg), jnp.asarray(k), jnp.asarray(v), causal=causal,
        row_offset=row_offset, block=16)
    # the kernel's layout: query head g * r + i of batch b at b * H + ...
    q_bh = torch.from_numpy(qg.transpose(0, 2, 3, 1, 4).reshape(-1, s, d))
    k_bh, v_bh = (torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(-1, skv, d))
                  for a in (k, v))
    for fn in (flash_attention_ref, flash_attention_kernel):
        out = fn(q_bh, k_bh, v_bh, causal=causal, row_offset=row_offset)
        out = out.reshape(b, g, r, s, d).permute(0, 3, 1, 2, 4)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def _bf16_terms(p: torch.Tensor, n: int) -> list[torch.Tensor]:
    """fp32 ``p`` as ``n`` bf16 terms, each the bf16 rounding of what the
    earlier terms leave (the split the bf16 kernel makes of P)."""
    terms = []
    for _ in range(n):
        terms.append(p.bfloat16().float())
        p = p - terms[-1]
    return terms


@pytest.mark.parametrize("n_terms,within_one_step", [(2, False), (3, True)])
def test_bf16_kernel_needs_p_in_three_bf16_terms(n_terms, within_one_step):
    """The bf16 kernel multiplies P V on bf16 tensor cores into fp32, and
    the reference's P is fp32. Emulated here with exact products: P in
    three bf16 terms keeps every output within one bf16 step of the plain
    version; in two (16 bits of P) short causal rows whose output is near
    0 leave it."""
    rng = np.random.default_rng(0)
    bh, sq, d = 64, 64, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, sq, d),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(3))
    ref = flash_attention_ref(q, k, v).float()
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    s = torch.where(torch.ones(sq, sq, dtype=torch.bool).tril(), s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    acc = sum(torch.einsum("bqk,bkd->bqd", t.double(), v.double())
              for t in _bf16_terms(p, n_terms))
    out = (acc / p.double().sum(-1, keepdim=True)).float().bfloat16().float()
    ratio = float(((out - ref).abs() / (2.0 ** -7 * ref.abs() + 1e-6)).max())
    assert (ratio <= 1.0) == within_one_step, ratio


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` does: to the
    nearest of 10 mantissa bits, ties away from zero, by integer operations
    on the bits (adding half of the dropped 13 bits rounds the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo, both TF32, as the GEMM kernel splits each operand; the
    subtraction is exact in fp32."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


@pytest.mark.parametrize("n_products,holds", [(1, False), (3, True)])
def test_fp32_gemm_needs_three_tf32_products(n_products, holds):
    """The fp32 GEMM kernel (K1, K2) multiplies on TF32 tensor cores into an
    fp32 accumulator, and is held to ``1e-4 * max(1, max|ref|)`` of the
    fp32 plain version. Emulated here with exact products (float64) at a
    conv10-like shape cut in M (128 x 4608 x 64): one TF32 product
    (hi * hi) misses that bound; three (lo * hi + hi * lo + hi * hi) hold
    it."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((128, 4608), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((4608, 64), dtype=np.float32))
    ref = conv_gemm_ref(a, b)
    (a_hi, a_lo), (b_hi, b_lo) = _tf32_split(a), _tf32_split(b)
    terms = [(a_hi, b_hi)] if n_products == 1 else [
        (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
    out = sum(x.double() @ y.double() for x, y in terms).float()
    err = float((out - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    assert (err <= tol) == holds, (err, tol)


def test_tf32_hi_lo_split_rebuilds_fp32():
    """hi + lo rebuilds every fp32 value to within 2**-22 of it (hi keeps 11
    significant bits, lo the next 11), over normal values of many scales."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(1 << 16) * np.exp2(
        rng.integers(-60, 60, 1 << 16))).astype(np.float32))
    hi, lo = _tf32_split(x)
    for part in (hi, lo):   # both are TF32: the low 13 bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22, float(rel)


def test_flash_attention_kv_len_masks_padded_columns():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a[0]) for a in _qkv(rng, 1, 2, 1, 30, 50, 8))
    out = flash_attention_kernel(q, k, v, causal=False, kv_len=33)
    ref = flash_attention_kernel(q, k[:, :33].contiguous(),
                                 v[:, :33].contiguous(), causal=False)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    z = torch.zeros
    with pytest.raises(ValueError, match="head_dim 160"):
        flash_attention_kernel(z(2, 4, 160), z(2, 4, 160), z(2, 4, 160))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention_kernel(*(z(2, 4, 8, dtype=torch.float16),) * 3)
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention_kernel(z(3, 4, 8), z(2, 4, 8), z(2, 4, 8))
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_kernel(z(2, 4, 8), z(2, 4, 8), z(2, 5, 8))
    with pytest.raises(ValueError, match="kv_len"):
        flash_attention_kernel(z(2, 4, 8), z(2, 4, 8), z(2, 4, 8), kv_len=5)
    with pytest.raises(ValueError, match="row_offset -1"):
        flash_attention_kernel(z(2, 4, 8), z(2, 4, 8), z(2, 4, 8),
                               row_offset=-1)
    with pytest.raises(TypeError, match="expected"):
        flash_attention_kernel(z(2, 4, 8), z(2, 4, 8).double(), z(2, 4, 8))
    with pytest.raises(ValueError, match="disagree"):
        flash_attention(z(1, 4, 8, 16), z(1, 3, 8, 16), z(1, 3, 8, 16))
