"""On a CUDA card only: each hand-written kernel against its plain PyTorch
version, and the port's whole ``hopper`` path against its ``torch`` path.

This file imports neither JAX nor the reference package, so it runs on a
card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Every case carries the ``gpu`` marker and skips without a card. Tolerance:
``1e-4 * max(1, max|ref|)`` per fp32 kernel (fp32 sums taken in another
order; for K1/K2 on the tensor cores also the 3xTF32 split, which leaves
about 2**-22 of each product), ``1e-4 * max|logit|`` on the reduced-VGG16
fp32 logits and ``1e-3 * max|logit|`` on the ResNet-18 ones (Winograd against direct
convolution over 20 layers); every int8 result bit for bit (integer sums
are exact in any order). K6 (flash attention): fp32 within
``1e-4 * max(1, max|ref|)``, bf16 element by element within
``2**-7 * |ref| + 1e-6`` (the kernel and its plain version both compute in
fp32 and round once to bf16, so they differ by at most one bf16 step); the
reduced LM's fp32 logits within ``1e-4 * max(1, max|logit|)`` of
``backend="torch"``; the MoE FFN and each reduced family's prefill and
three train steps on the card against the CPU (``1e-4``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.compiler import LayerPlan  # noqa: E402
from repro_torch.core.program_cache import ProgramCache  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.core.hybrid_conv import (  # noqa: E402
    ConvSpec,
    DepthwiseSpec,
    FCSpec,
    PoolSpec,
    explicit_pads,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref  # noqa: E402
from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref  # noqa: E402
from repro_torch.kernels.spatial_conv import ops as conv_ops  # noqa: E402
from repro_torch.kernels.spatial_conv.kernel import (  # noqa: E402
    conv_gemm_f32,
    conv_gemm_ref,
    conv_implicit_f32,
    im2col,
    takes_implicit,
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_kernel,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref,
)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers, resnet, vgg  # noqa: E402
from repro_torch.train import steps  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gpu_close(y, y_ref):
    torch.cuda.synchronize()
    tol = 1e-4 * max(1.0, float(y_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= tol


def _misaligned(*shape, device):
    """A contiguous tensor whose data pointer is 4 bytes off a 16-byte
    boundary: the GEMM's scalar load path."""
    n = int(np.prod(shape))
    return torch.randn(n + 1, device=device)[1:].view(*shape)


# (shape, the route the kernel takes for 16-byte aligned operands): every
# route of csrc/gemm_f32.cu. tc3xtf32 where M >= 64 and K, N are multiples
# of 4 (here with M not a multiple of 64, N not one of the tile, K not one of
# the 32-float slab, BN 64 and 128, split K), the FMA body else (K = 27,
# M < 64, N % 4 != 0, the M = 8 FC layers).
CONV_GEMM_CASES = [
    pytest.param(37, 5, 3, "fma", id="37-5-3"),
    pytest.param(1000, 27, 64, "fma", id="1000-27-64"),
    pytest.param(300, 1152, 130, "fma_splitk", id="300-1152-130"),
    pytest.param(20000, 64, 68, "tc3xtf32", id="20000-64-68"),
    pytest.param(9000, 36, 60, "tc3xtf32", id="9000-36-60"),
    pytest.param(300, 1152, 196, "tc3xtf32", id="300-1152-196"),
    pytest.param(1568, 4608, 512, "tc3xtf32", id="1568-4608-512"),
]


@pytest.mark.parametrize("t,crs,k,route", CONV_GEMM_CASES)
def test_gpu_conv_gemm(cuda, t, crs, k, route):
    p, w, b = (torch.randn(*s, device=cuda) for s in ((t, crs), (crs, k), (k,)))
    before = dict(common.LAUNCHES)
    for relu, df in [(True, "is"), (False, "ws")]:
        _gpu_close(conv_gemm_f32(p, w, b, relu, df),
                   conv_gemm_ref(p, w, b, relu, df))
        assert common.last_route("conv_gemm_f32") == route
    # each K1 launch counts once, under the entry that ran
    assert common.LAUNCHES["conv_gemm_f32"] == before["conv_gemm_f32"] + 2
    assert (common.LAUNCHES["conv_implicit_f32"]
            == before["conv_implicit_f32"])


# K1 over the map itself: (n, h, c, k, r, stride) of every Spatial conv of
# VGG16's main path (the DSE's plans at buckets 1 and 8 at 224x224: conv1
# and conv7 only at bucket 1, conv10-12 split K; conv2-6 at bucket 128) and
# ResNet-18's 3x3/2 and 1x1/2 convs at batch 8, SAME padding (asymmetric at
# stride 2)
_VGG16_SPATIAL = [("conv1", 224, 64, 64), ("conv2", 112, 64, 128),
                  ("conv3", 112, 128, 128), ("conv4", 56, 128, 256),
                  ("conv5", 56, 256, 256), ("conv7", 28, 256, 512),
                  ("conv10", 14, 512, 512)]
IMPLICIT_CASES = [
    pytest.param(n, hw, c, k, 3, 1, id=f"vgg16-{name}-b{n}")
    for n in (1, 8) for name, hw, c, k in _VGG16_SPATIAL
    if n == 1 or name not in ("conv1", "conv7")
] + [
    pytest.param(128, hw, c, k, 3, 1, id=f"vgg16-{name}-b128")
    for name, hw, c, k in _VGG16_SPATIAL[1:5]
] + [
    pytest.param(8, hw, c, 2 * c, r, 2, id=f"resnet18-{hw}-{c}-{r}x{r}s2")
    for hw, c in ((56, 64), (28, 128), (14, 256)) for r in (3, 1)
]


@pytest.mark.parametrize("n,hw,c,k,r,stride", IMPLICIT_CASES)
def test_gpu_conv_implicit_equals_patch_gemm(cuda, n, hw, c, k, r, stride):
    """conv_implicit_f32 on the map is torch.equal to conv_gemm_f32 on
    im2col's patches (the same plan, the same sums), on the tensor-core
    route, counted once a call under its own entry."""
    x, g, b = (torch.randn(*s, device=cuda)
               for s in ((n, hw, hw, c), (r, r, c, k), (k,)))
    pads = explicit_pads("SAME", hw, hw, r, r, stride)
    assert takes_implicit(x, g, stride, pads)
    patches, (ho, wo) = im2col(x, r, r, stride, pads)
    for relu, df in [(True, "is"), (False, "ws")]:
        before = dict(common.LAUNCHES)
        y = conv_implicit_f32(x, g, b, stride=stride, pads=pads, relu=relu,
                              dataflow=df)
        assert common.last_route("conv_implicit_f32") == "tc3xtf32"
        y_patch = conv_gemm_f32(patches, g.view(-1, k), b, relu, df)
        torch.cuda.synchronize()
        assert torch.equal(y, y_patch.view(n, ho, wo, k))
        for name in ("conv_implicit_f32", "conv_gemm_f32"):
            assert common.LAUNCHES[name] == before[name] + 1
    _gpu_close(y.view(-1, k), conv_gemm_ref(patches, g.view(-1, k), b))


def test_gpu_conv_implicit_reads_a_row_slab_view(cuda):
    """A row slab of a larger map (a strided view, as the blocked lowering
    hands it) with only the width pads: torch.equal to the patch GEMM."""
    big = torch.randn(8, 30, 56, 128, device=cuda)
    x, g = big[:, 5:23], torch.randn(3, 3, 128, 256, device=cuda)
    pads = ((0, 0), (1, 1))
    assert not x.is_contiguous() and takes_implicit(x, g, 1, pads)
    y = conv_implicit_f32(x, g, None, pads=pads)
    patches, (ho, wo) = im2col(x, 3, 3, 1, pads)
    y_patch = conv_gemm_f32(patches, g.view(-1, 256))
    torch.cuda.synchronize()
    assert (ho, wo) == (16, 56)
    assert torch.equal(y, y_patch.view(8, ho, wo, 256))


def test_gpu_vgg16_k1_reads_the_map(cuda, monkeypatch):
    """Full VGG16 fp32 at batch 8 on hopper (the default DSE: 9 Spatial
    convs): a captured replay launches K1 once over patches (conv0, C = 3)
    and 8 times over the map, and its logits are torch.equal to the same
    lowering with every Spatial conv over im2col's patches."""
    acc = api.Accelerator.build(vgg.network_specs(), batch=8,
                                backend="hopper", device=cuda,
                                cache=ProgramCache())
    entry, params = acc.runtime.executor_entry(8, acc.input_dtype)
    x = _entry_input(acc, np.random.default_rng(3).standard_normal(
        (8, 224, 224, 3)).astype(np.float32))
    entry(params, x)                   # warm-up and capture
    common.reset_launches()
    y = entry(params, x).clone()       # a replay
    torch.cuda.synchronize()
    assert (common.LAUNCHES["conv_gemm_f32"],
            common.LAUNCHES["conv_implicit_f32"]) == (1, 8)
    monkeypatch.setattr(conv_ops, "takes_implicit", lambda *a: False)
    common.reset_launches()
    y_patch = entry.fn(params, x)
    torch.cuda.synchronize()
    assert (common.LAUNCHES["conv_gemm_f32"],
            common.LAUNCHES["conv_implicit_f32"]) == (9, 0)
    assert torch.equal(y, y_patch)


BMM_CASES = [
    pytest.param(2, 5, 3, 7, "fma", id="2-5-3-7"),
    pytest.param(36, 392, 256, 512, "tc3xtf32", id="36-392-256-512"),
    pytest.param(1, 8, 4096, 1000, "fma_splitk", id="1-8-4096-1000"),
    pytest.param(1, 17, 9, 65, "fma", id="1-17-9-65"),
    pytest.param(36, 2048, 64, 64, "tc3xtf32", id="36-2048-64-64"),
    pytest.param(36, 200, 68, 100, "tc3xtf32", id="36-200-68-100"),
    pytest.param(1, 8, 25088, 4096, "fma_splitk", id="1-8-25088-4096"),
]


@pytest.mark.parametrize("g,m,k,n,route", BMM_CASES)
def test_gpu_bmm(cuda, g, m, k, n, route):
    a, b, bias = (torch.randn(*s, device=cuda)
                  for s in ((g, m, k), (g, k, n), (g, n)))
    _gpu_close(bmm_f32(a, b), bmm_ref(a, b))
    assert common.last_route("bmm_f32") == route
    _gpu_close(bmm_f32(a, b, bias, True, "ws"), bmm_ref(a, b, bias, True))
    assert common.last_route("bmm_f32") == route
    # a pointer 4 bytes off a 16-byte boundary: the FMA body's scalar path
    a_off = _misaligned(g, m, k, device=cuda)
    _gpu_close(bmm_f32(a_off, b, bias), bmm_ref(a_off, b, bias))
    assert common.last_route("bmm_f32") in ("fma", "fma_splitk")


@pytest.mark.parametrize("m", [2, 4])
def test_gpu_winograd_transforms(cuda, m):
    pt = m + 2
    tiles = torch.randn(392, pt, pt, 64, device=cuda)
    _gpu_close(wino_input_transform_f32(tiles, m),
               wino_input_transform_ref(tiles, m))
    mm, bias = torch.randn(pt * pt, 392, 48, device=cuda), torch.randn(
        48, device=cuda)
    _gpu_close(wino_output_transform_f32(mm, bias, m, True),
               wino_output_transform_ref(mm, bias, m, True))


# (N, H, W, C, K, pads, m): K3's input and K4's output geometry. A ragged
# one (Ho, Wo not multiples of m, odd pads) with C = K = 5 (the scalar
# route) and with C = 12, K = 8 (float4), and ResNet-18's s1 layer at batch
# 8 as the executor gives it (the slab's 66 rows, the width pad as
# geometry; float4).
WINO_NHWC_CASES = [
    pytest.param(2, 13, 11, 5, 5, ((1, 2), (0, 1)), m, id=f"ragged-c5-m{m}")
    for m in (2, 4)
] + [
    pytest.param(2, 13, 11, 12, 8, ((1, 2), (0, 1)), 4, id="ragged-c12-m4"),
    pytest.param(3, 9, 10, 16, 20, ((0, 0), (0, 0)), 2, id="valid-c16-m2"),
    pytest.param(8, 66, 64, 64, 64, ((0, 0), (1, 1)), 4, id="resnet18-s1"),
]


def _route(channels):
    return "vec4" if channels % 4 == 0 else "scalar"


@pytest.mark.parametrize("n,h,w,c,k,pad,m", WINO_NHWC_CASES)
def test_gpu_winograd_nhwc_fronts(cuda, n, h, w, c, k, pad, m):
    pt = m + 2
    ho, wo, nh, nw = wino_grid(h, w, m, pad)
    t = n * nh * nw
    x = torch.randn(n, h, w, c, device=cuda)
    before = dict(common.LAUNCHES)
    _gpu_close(wino_input_transform_nhwc_f32(x, m, pad),
               wino_input_transform_nhwc_ref(x, m, pad))
    assert common.last_route("wino_input_transform_f32") == _route(c)
    mm, bias = (torch.randn(pt * pt, t, k, device=cuda),
                torch.randn(k, device=cuda))
    for relu in (False, True):
        _gpu_close(
            wino_output_transform_nhwc_f32(mm, bias, m, (n, ho, wo), relu),
            wino_output_transform_nhwc_ref(mm, bias, m, (n, ho, wo), relu))
        assert common.last_route("wino_output_transform_f32") == _route(k)
    _gpu_close(wino_output_transform_nhwc_f32(mm, None, m, (n, ho, wo)),
               wino_output_transform_nhwc_ref(mm, None, m, (n, ho, wo)))
    # the reference's tiles layouts, on the same kernels
    tiles = torch.randn(t, pt, pt, c, device=cuda)
    _gpu_close(wino_input_transform_f32(tiles, m),
               wino_input_transform_ref(tiles, m))
    assert common.last_route("wino_input_transform_f32") == _route(c)
    _gpu_close(wino_output_transform_f32(mm, bias, m, True),
               wino_output_transform_ref(mm, bias, m, True))
    assert common.last_route("wino_output_transform_f32") == _route(k)
    assert common.LAUNCHES["wino_input_transform_f32"] == (
        before["wino_input_transform_f32"] + 2)
    assert common.LAUNCHES["wino_output_transform_f32"] == (
        before["wino_output_transform_f32"] + 4)


def test_gpu_winograd_misaligned_takes_scalar_route(cuda):
    """Channels in fours but a pointer 4 bytes off a 16-byte boundary: the
    scalar route, with the same results."""
    x = _misaligned(2, 10, 9, 8, device=cuda)
    pad = ((1, 1), (1, 1))
    _gpu_close(wino_input_transform_nhwc_f32(x, 4, pad),
               wino_input_transform_nhwc_ref(x, 4, pad))
    assert common.last_route("wino_input_transform_f32") == "scalar"
    mm = _misaligned(36, 2 * 3 * 3, 8, device=cuda)
    _gpu_close(wino_output_transform_nhwc_f32(mm, None, 4, (2, 10, 9)),
               wino_output_transform_nhwc_ref(mm, None, 4, (2, 10, 9)))
    assert common.last_route("wino_output_transform_f32") == "scalar"


def test_gpu_launch_keeps_the_current_device(cuda):
    """common.launch no longer enters torch.cuda.device: each entry makes
    its tensors' device current for the launch and gives the caller's back
    (K2, K3, K5 and K6 here, one per source file)."""
    before = torch.cuda.current_device()
    a, b = torch.randn(1, 64, 64, device=cuda), torch.randn(1, 64, 64,
                                                            device=cuda)
    bmm_f32(a, b)
    assert torch.cuda.current_device() == before
    wino_input_transform_nhwc_f32(torch.randn(1, 6, 6, 4, device=cuda), 4)
    assert torch.cuda.current_device() == before
    i8 = torch.ones(64, 64, dtype=torch.int8, device=cuda)
    qmm_i8(i8, i8, torch.zeros(64, dtype=torch.int32, device=cuda),
           torch.ones(64, device=cuda), True)
    assert torch.cuda.current_device() == before
    q = torch.randn(2, 16, 64, device=cuda)
    flash_attention_kernel(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert torch.cuda.current_device() == before


def _mixed_plans(specs):
    """Winograd on every other CONV (m = 2 and 4 in turn), IS/WS
    alternating, 2x2 row/k groups on the first two CONVs."""
    plans, ci = [], 0
    for s in specs:
        if isinstance(s, ConvSpec):
            g = 2 if ci < 2 else 1
            plans.append(LayerPlan("wino" if ci % 2 == 0 else "spat",
                                   "is" if ci % 2 else "ws",
                                   4 if ci % 4 == 0 else 2, g, g))
            ci += 1
        else:
            plans.append(None)
    return plans


@pytest.mark.parametrize("opt_level", [0, 1])
def test_gpu_reduced_vgg16_hopper_matches_torch(cuda, opt_level):
    specs = vgg.network_specs(img=32, scale=32, n_classes=10)
    plans = _mixed_plans(specs)
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = api.Accelerator.build(specs, plans=plans, batch=2,
                                backend="torch", device=cuda)
    acc = api.Accelerator.build(specs, plans=plans, batch=2,
                                backend="hopper", params=ref.params,
                                opt_level=opt_level, device=cuda)
    common.reset_launches()
    y = acc(x)
    torch.cuda.synchronize()
    # every fp32 kernel, and not the int8 GEMM
    assert all(n for name, n in common.LAUNCHES.items()
               if name not in ("qmm_i8", "flash_attention"))
    assert common.LAUNCHES["qmm_i8"] == common.LAUNCHES["flash_attention"] == 0
    y, y_ref = y.cpu().numpy(), ref(x).cpu().numpy()
    assert np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= 1e-4 * np.abs(y_ref).max()


def _i8(*shape, device, gen=None):
    return torch.randint(-127, 128, shape, dtype=torch.int8, device=device,
                         generator=gen)


# (shape, the route K5 takes for 16-byte aligned operands): every route of
# csrc/gemm_i8.cu. tc_s8 where M >= 64 and K, N are multiples of 16 (here
# with ragged M, a K tail short of the 128-byte slab, K below one slab, split
# K, BN 64 and 128, ragged N in both); dp4a (32-bit words) or dp4a_bytes
# (byte-wise) else: K = 27, N % 4 != 0, M < 64, K or N not a multiple of 16,
# the M = 8 FC layers.
QMM_CASES = [
    pytest.param(33, 27, 10, "dp4a_bytes", id="33-27-10"),
    pytest.param(1000, 27, 64, "dp4a_bytes", id="1000-27-64"),
    pytest.param(300, 1152, 128, "tc_s8", id="300-1152-128"),
    pytest.param(8, 25088, 1000, "dp4a", id="8-25088-1000"),
    pytest.param(1568, 4608, 512, "tc_s8", id="1568-4608-512"),
    pytest.param(2048, 576, 256, "tc_s8", id="2048-576-256"),
    pytest.param(1000, 576, 128, "tc_s8", id="1000-576-128"),
    pytest.param(512, 4608, 512, "tc_s8", id="512-4608-512"),
    pytest.param(32768, 576, 64, "tc_s8", id="32768-576-64"),
    pytest.param(8192, 64, 128, "tc_s8", id="8192-64-128"),
    pytest.param(200, 32, 48, "tc_s8", id="200-32-48"),
    pytest.param(130, 144, 144, "tc_s8", id="130-144-144"),
    pytest.param(60, 1152, 128, "dp4a", id="60-1152-128"),
    pytest.param(300, 1156, 132, "dp4a", id="300-1156-132"),
    pytest.param(20000, 580, 260, "dp4a", id="20000-580-260"),
]


@pytest.mark.parametrize("m,k,n,route", QMM_CASES)
def test_gpu_qmm_i8(cuda, m, k, n, route):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _i8(m, k, device=cuda, gen=gen), _i8(k, n, device=cuda, gen=gen)
    bias = torch.randint(-50000, 50000, (n,), dtype=torch.int32,
                         device=cuda, generator=gen)
    mult = torch.rand(n, device=cuda, generator=gen) * 1e-4
    # multipliers that spread the sums over the int8 range (few clamp)
    spread = (torch.rand(n, device=cuda, generator=gen) + 0.5) / (
        127.0 * k ** 0.5)
    before = common.LAUNCHES["qmm_i8"]
    for relu, mu in [(False, mult), (True, mult), (False, spread),
                     (True, spread)]:
        y = qmm_i8(a, b, bias, mu, relu)
        torch.cuda.synchronize()
        assert torch.equal(y, qmm_ref(a, b, bias, mu, relu))
        assert common.last_route("qmm_i8") == route
    assert common.LAUNCHES["qmm_i8"] == before + 4
    # a misaligned A (one byte off) takes the byte-wise path
    a_off = _i8(m * k + 1, device=cuda, gen=gen)[1:].view(m, k)
    assert torch.equal(qmm_i8(a_off, b, bias, mult),
                       qmm_ref(a_off, b, bias, mult))
    assert common.last_route("qmm_i8") == "dp4a_bytes"


def test_gpu_qmm_i8_rounds_large_accumulators(cuda):
    """|acc| above 2**24: the int32 -> float32 conversion rounds, and the
    kernel must round exactly as the plain version does."""
    k = 4608
    a = torch.full((40, k), 127, dtype=torch.int8, device=cuda)
    b = torch.full((k, 12), 127, dtype=torch.int8, device=cuda)
    b[:, ::2] = -127
    bias = torch.arange(12, dtype=torch.int32, device=cuda) * 7 + 1
    mult = torch.full((12,), 1.7e-6, device=cuda)
    y = qmm_i8(a, b, bias, mult)
    assert torch.equal(y, qmm_ref(a, b, bias, mult))


@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_gpu_reduced_int8_hopper_matches_torch(cuda, model):
    specs = (vgg.network_specs(img=32, scale=16, n_classes=10)
             if model == "vgg16"
             else resnet.resnet18_specs(img=32, scale=16, n_classes=10))
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = api.Accelerator.build(specs, batch=2, backend="torch",
                                dtype="int8", device=cuda)
    # the same program, sidecar and quantized params on the hopper PE
    rt = HybridRuntime(ref.program, backend="hopper", device=cuda,
                       quant=ref.quant)
    rt.load_params(ref.params)
    q = ref.quant.quantize_input(torch.from_numpy(x).to(cuda))
    common.reset_launches()
    y = rt.run(q)
    torch.cuda.synchronize()
    n_gemm = sum(cl.kind in ("conv", "fc") for cl in ref.program.layers)
    assert common.LAUNCHES["qmm_i8"] == n_gemm
    assert torch.equal(y, ref.runtime.run(q))


@pytest.mark.parametrize("opt_level", [0, 1])
def test_gpu_reduced_resnet18_fp32_hopper_matches_torch(cuda, opt_level):
    specs = resnet.resnet18_specs(img=32, scale=16, n_classes=10)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    ref = api.Accelerator.build(specs, batch=2, backend="torch",
                                device=cuda)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                params=ref.params, opt_level=opt_level,
                                device=cuda)
    y, y_ref = acc(x).cpu().numpy(), ref(x).cpu().numpy()
    assert np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= 1e-3 * np.abs(y_ref).max()


# ---------------------------------------------------------------------------
# The strict interpreter and the depthwise path on the card
# ---------------------------------------------------------------------------

def _held_strict(acc, inp, cuda):
    """``acc``'s program on the hopper interpreter and the opt_level=0
    hopper executor: the same kernel calls, the same bits."""
    st = HybridRuntime(acc.program, strict=True, backend="hopper",
                       device=cuda, quant=acc.quant)
    st.load_params(acc.params)
    ex0 = HybridRuntime(acc.program, backend="hopper", opt_level=0,
                        device=cuda, quant=acc.quant)
    ex0.load_params(acc.params)
    common.reset_launches()
    y = st.run(inp)
    torch.cuda.synchronize()
    launches = dict(common.LAUNCHES)
    common.reset_launches()
    y0 = ex0.run(inp)
    torch.cuda.synchronize()
    assert launches == common.LAUNCHES and any(launches.values())
    assert torch.equal(y, y0)
    return y


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_gpu_strict_interpreter_hopper_matches_opt0(cuda, model, dtype):
    """Reduced models (VGG16 fp32 on the Winograd/grouped plans of the test
    above), the interpreter bit for bit against the opt_level=0 executor,
    int8 also against the served opt_level=1 one."""
    if model == "vgg16":
        specs = vgg.network_specs(img=32, scale=32, n_classes=10)
        plans = _mixed_plans(specs) if dtype == "float32" else None
    else:
        specs = resnet.resnet18_specs(img=32, scale=16, n_classes=10)
        plans = None
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    acc = api.Accelerator.build(specs, plans=plans, batch=2,
                                backend="hopper", dtype=dtype, device=cuda)
    inp = x if acc.quant is None else acc.quant.quantize_input(x)
    y = _held_strict(acc, inp, cuda)
    y1 = acc.runtime.run(inp)
    if acc.quant is not None:
        assert torch.equal(y, y1)
    else:
        assert float((y - y1).abs().max()) <= 1e-4 * float(y1.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gpu_depthwise_chain_hopper_matches_torch(cuda, dtype):
    """The reference's conv -> depthwise -> depthwise(stride 2) -> FC chain
    (with a pool): hopper against torch (fp32 within 1e-4 max|logit|, int8
    bit for bit) and the interpreter against opt_level=0."""
    specs = [ConvSpec("c1", 16, 16, 8, 16), DepthwiseSpec("d1", 16, 16, 16),
             DepthwiseSpec("d2", 16, 16, 16, stride=2),
             PoolSpec("p1", 8, 8, 16), FCSpec("f1", 4 * 4 * 16, 10)]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 16, 16, 8)).astype(np.float32)).to(cuda)
    if dtype == "int8":
        acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                    dtype=dtype, device=cuda)
        # the same program, sidecar and int8 params on the torch PE
        ref = HybridRuntime(acc.program, backend="torch", device=cuda,
                            quant=acc.quant)
        ref.load_params(acc.params)
        q = acc.quant.quantize_input(x)
        common.reset_launches()
        y = acc.runtime.run(q)
        assert common.LAUNCHES["qmm_i8"] == 2
        assert torch.equal(y, ref.run(q))
        _held_strict(acc, q, cuda)
    else:
        ref = api.Accelerator.build(specs, batch=2, backend="torch",
                                    device=cuda)
        acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                    params=ref.params, device=cuda)
        y, y_ref = acc(x), ref(x)
        assert torch.isfinite(y).all()
        assert float((y - y_ref).abs().max()) <= \
            1e-4 * float(y_ref.abs().max())
        _held_strict(acc, x, cuda)


# ---------------------------------------------------------------------------
# K6: flash attention, and the LM serving path
# ---------------------------------------------------------------------------

FA_GPU_CASES = [
    # (b, h, hkv, sq, skv, d, causal[, row_offset])
    (1, 2, 2, 64, 64, 16, True),
    (2, 4, 2, 100, 100, 64, True),      # ragged, GQA 2
    (1, 8, 2, 40, 72, 128, True),       # Sq < Skv, GQA 4
    (2, 4, 1, 333, 517, 64, False),     # ragged, non-causal, GQA 4
    (1, 4, 4, 130, 70, 128, True),      # Sq > Skv
    (1, 2, 1, 300, 300, 16, False),
    (1, 2, 2, 17, 5, 7, True),          # D not a multiple of 4
    (2, 4, 2, 150, 260, 8, True),       # D 8: whole 16-byte rows
    (1, 8, 2, 300, 1100, 128, True, 700),   # a chunk at row offset 700
    (1, 4, 1, 2048, 2100, 128, True),   # long rows: 33 KV steps, GQA 4
    (1, 2, 1, 2048, 4112, 128, True, 2048),  # a long chunk past 0
    (1, 4, 4, 300, 300, 112, True),     # D 112 (zamba2's), Sq = Skv
    (2, 4, 4, 200, 520, 112, True),     # D 112, Sq < Skv
    (1, 4, 1, 2048, 1600, 128, False),  # the VLM's cross shape: Skv 1600
    (2, 40, 8, 4096, 4112, 128, True),  # the MoE prefill: 40 over 8 heads
    # a position of internlm2-20b's 48 over 8 heads on 6 (8 heads that
    # straddle two KV groups: K and V indexed to one head each)
    (2, 8, 8, 4096, 4112, 128, True),
]


@pytest.mark.parametrize("case", FA_GPU_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_flash_attention(cuda, case, dtype):
    b, h, hkv, sq, skv, d, causal, *rest = case
    row_offset = rest[0] if rest else 0
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(sum(case[:6]))
    q = torch.randn(b, h, sq, d, device=cuda, generator=gen).to(dt)
    k = torch.randn(b, hkv, skv, d, device=cuda, generator=gen).to(dt)
    v = torch.randn(b, hkv, skv, d, device=cuda, generator=gen).to(dt)
    before = common.LAUNCHES["flash_attention"]
    out = flash_attention(q, k, v, causal=causal, row_offset=row_offset)
    torch.cuda.synchronize()
    assert common.LAUNCHES["flash_attention"] == before + 1
    assert out.dtype == dt and out.shape == q.shape
    ref = flash_attention_ref(q.reshape(b * h, sq, d),
                              k.reshape(b * hkv, skv, d),
                              v.reshape(b * hkv, skv, d), causal=causal,
                              row_offset=row_offset).reshape(b, h, sq, d)
    if dt == torch.float32:
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((out - ref).abs().max()) <= tol
    else:
        diff = (out.float() - ref.float()).abs()
        assert bool((diff <= 2.0 ** -7 * ref.float().abs() + 1e-6).all())


def test_gpu_flash_attention_kv_len_and_head_dim_limit(cuda):
    q, k, v = (torch.randn(2, n, 64, device=cuda) for n in (30, 50, 50))
    _gpu_close(flash_attention_kernel(q, k, v, causal=False, kv_len=33),
               flash_attention_ref(q, k, v, causal=False, kv_len=33))
    big = torch.zeros(2, 8, 160, device=cuda)
    before = common.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="head_dim 160"):
        flash_attention_kernel(big, big, big)
    assert common.LAUNCHES["flash_attention"] == before


def test_gpu_reduced_lm_hopper_matches_torch(cuda):
    """Reduced minitron-8b (fp32), a 2048-token prompt: the prefill's
    attention runs K6 once per layer under hopper, the scan under torch."""
    cfg = get_config("minitron-8b").reduced()
    params = steps.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    common.reset_launches()
    out = serve("minitron-8b", batch=2, prompt_len=2048, gen=4,
                backend="hopper", device=cuda, params=params)
    assert common.LAUNCHES["flash_attention"] == cfg.n_layers
    ref = serve("minitron-8b", batch=2, prompt_len=2048, gen=4,
                backend="torch", device=cuda, params=params)
    assert common.LAUNCHES["flash_attention"] == cfg.n_layers
    y, y_ref = out.prefill_logits, ref.prefill_logits
    assert torch.isfinite(y).all()
    tol = 1e-4 * max(1.0, float(y_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= tol


@pytest.mark.parametrize("arch,prompt", [
    ("mamba2-130m", 100), ("zamba2-7b", 2048), ("whisper-base", 32),
    ("llama-3.2-vision-11b", 2048), ("llama4-scout-17b-16e", 2048),
    ("llama4-maverick-400b-a17b", 32)])
def test_gpu_reduced_family_matches_cpu(cuda, arch, prompt):
    """Each family the port serves besides the dense one, reduced and in
    fp32, on the card (hopper: K6 at zamba2's and the VLM's 2048-token
    prompts) and on the CPU from one tree."""
    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "vlm":    # open the cross layers' zero-init gates
        for slot in params["layers"]:
            if "xattn_gate" in slot:
                slot["xattn_gate"].fill_(0.5)
    kw = dict(batch=2, prompt_len=prompt, gen=4, backend="hopper")
    common.reset_launches()
    out = serve(arch, device=cuda, params=layers._tree_map(
        lambda t: t.to(cuda), params), **kw)
    long = prompt >= layers.LONG_SEQ
    per_prefill = {"hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1),
                   "vlm": cfg.n_layers + cfg.n_layers // max(
                       cfg.cross_attn_every, 1),
                   "moe": cfg.n_layers if long else 0}.get(cfg.family, 0)
    assert common.LAUNCHES["flash_attention"] == per_prefill
    ref = serve(arch, device="cpu", params=params, **kw)
    y, y_ref = out.prefill_logits.cpu(), ref.prefill_logits
    assert torch.isfinite(y).all()
    tol = 1e-4 * max(1.0, float(y_ref.abs().max()))
    assert float((y - y_ref).abs().max()) <= tol


@pytest.mark.parametrize("capacity_factor", [0.5, 64.0])
@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e",
                                  "llama4-maverick-400b-a17b"])
def test_gpu_moe_matches_cpu(cuda, arch, capacity_factor):
    """``layers.moe`` (reduced, fp32, with and without capacity drops) and
    ``moe_ref`` on the card against the CPU from the same params: the
    same expert assignment (float32 router logits, no TF32), outputs
    within ``1e-4 * max(1, max|ref|)``."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              capacity_factor=capacity_factor)
    gen = torch.Generator().manual_seed(0)
    p = layers.init_moe(gen, cfg, torch.float32, "cpu")
    x = torch.randn(2, 300, cfg.d_model, generator=gen)
    p_dev = layers._tree_map(lambda t: t.to(cuda), p)
    idx = (x @ p["router"]).argmax(-1)
    assert torch.equal((x.to(cuda) @ p_dev["router"]).argmax(-1).cpu(), idx)
    for fn in (layers.moe, layers.moe_ref):
        y = fn(p_dev, x.to(cuda), cfg)
        _gpu_close(y.cpu(), fn(p, x, cfg))


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "mamba2-130m",
                                  "zamba2-7b", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_gpu_reduced_family_trains_as_on_cpu(cuda, arch):
    """Each family besides the dense one, reduced and in fp32, three train
    steps on the card from the CPU's parameters, batch 2 x 64: each loss
    within 1e-4 relative of the CPU's; no hand-written kernel launches."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import extras_for
    from repro_torch.optim import adamw
    from torch.utils import _pytree as pytree

    cfg = get_config(arch).reduced()
    cpu = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = pytree.tree_map(lambda t: t.to(cuda), cpu)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = steps.make_train_step(cfg, opt)
    data = DataConfig(cfg.vocab_size, 64, 2)
    runs = {}
    common.reset_launches()
    for name, params in (("cpu", cpu), ("cuda", dev)):
        state, out = adamw.init(params), []
        for i in range(3):
            b = batch_for_step(data, i)
            b.update(extras_for(cfg, 2, np.random.default_rng(i)))
            params, state, m = step(params, state, b)
            out.append(float(m["loss"]))
        runs[name] = out
    assert not any(common.LAUNCHES.values())
    for loss, r_loss in zip(runs["cuda"], runs["cpu"]):
        assert abs(loss - r_loss) <= 1e-4 * abs(r_loss)


# ---------------------------------------------------------------------------
# the ServingSession, persistence and the segmented path on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_gpu_session_bulk_equals_direct_call(cuda, model, dtype):
    """Reduced models through a hopper ServingSession: full-bucket bulk
    results equal ``acc(x)`` bit for bit (same entry, offset 0), coalesced
    single images stay within 1e-3 max|logit| of their row (int8 bit for
    bit), no batch degraded, and the kernels launched once per layer per
    batch."""
    build = vgg.network_specs if model == "vgg16" else resnet.resnet18_specs
    specs = build(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                dtype=dtype, device=cuda)
    x = np.random.default_rng(5).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    y_direct = [acc(x[i:i + 4]).cpu().numpy() for i in (0, 4)]
    torch.cuda.synchronize()
    common.reset_launches()
    acc(x[:4])
    per_batch = {k: v for k, v in common.LAUNCHES.items() if v}
    with acc.serve(max_batch=4, buckets=(1, 2, 4), warmup=True) as s:
        common.reset_launches()
        out = s.run_many([x[:4], x[4:]])
        assert {k: v for k, v in common.LAUNCHES.items() if v} == \
            {k: 2 * v for k, v in per_batch.items()}
        futs = s.submit_many(list(x))
        rows = [f.result(timeout=120) for f in futs]
        st = s.stats
    for got, ref in zip(out, y_direct):
        np.testing.assert_array_equal(got, ref)
    ref_rows = np.concatenate(y_direct)
    if dtype == "int8":
        np.testing.assert_array_equal(np.stack(rows), ref_rows)
    else:
        assert np.abs(np.stack(rows) - ref_rows).max() <= \
            1e-3 * np.abs(ref_rows).max()
    assert st.degraded == 0 and st.errors == 0
    assert st.submitted == st.requests + st.errors + st.shed == 10


def test_gpu_session_bisects_a_mid_stream_hopper_failure(cuda):
    """A one-shot ``execute`` error on the fourth of eight hopper batches of
    a ``run_many`` stream: that batch is bisected on hopper (never re-run on
    aten), and every result equals ``acc(x)``'s row bit for bit."""
    from repro_torch.serving import FaultPlan, FaultSpec
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                device=cuda)
    x = np.random.default_rng(6).standard_normal(
        (32, 32, 32, 3)).astype(np.float32)
    ref = np.concatenate([acc(x[i:i + 4]).cpu().numpy()
                          for i in range(0, 32, 4)])
    plan = FaultPlan([FaultSpec(site="execute", kind="error", at=(3,),
                                match=(("backend", "hopper"),))])
    with acc.serve(max_batch=4, buckets=(4,), warmup=True,
                   fault_plan=plan) as s:
        out = s.run_many(list(x))
        st = s.stats
    np.testing.assert_array_equal(np.stack(out), ref)
    assert len(plan.fired()) == 1 and st.retries == 2
    assert st.degraded == 0 and st.isolated == 0 and st.errors == 0
    assert st.submitted == st.requests == 32


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_gpu_concurrent_run_many_callers_bit_exact(cuda, dtype):
    """Three threads call ``run_many`` on one hopper session at once, each
    with eight full-bucket requests, while the pipeline keeps three batches
    in flight: every result equals ``acc(x)`` on its batch bit for bit (a
    staging entry refilled while its batch is in flight would hand a
    caller another batch's logits)."""
    from concurrent.futures import ThreadPoolExecutor
    specs = vgg.network_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                dtype=dtype, device=cuda)
    rng = np.random.default_rng(9)
    callers = [[rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
                for _ in range(8)] for _ in range(3)]
    refs = [[acc(b).cpu().numpy() for b in reqs] for reqs in callers]
    with acc.serve(max_batch=4, buckets=(4,), warmup=True) as s:
        with ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(s.run_many, reqs) for reqs in callers]
            outs = [f.result(timeout=300) for f in futs]
        st = s.stats
    for out, ref in zip(outs, refs):
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got, want)
    assert st.errors == 0 and st.requests == st.batches == 24


def test_gpu_save_and_load_program_bit_for_bit(cuda, tmp_path):
    specs = vgg.network_specs(32, 16, n_classes=10)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    for dtype in ("float32", "int8"):
        acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                    dtype=dtype, device=cuda)
        path = acc.save_program(str(tmp_path / f"{dtype}.json"))
        again = api.Accelerator.from_program(path, params=acc.params,
                                             backend="hopper", device=cuda)
        assert torch.equal(again(x), acc(x))


def test_gpu_segmented_vgg16_matches_single_program(cuda):
    specs = vgg.network_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                device=cuda)
    seg = api.Accelerator.build(specs, batch=2, backend="hopper",
                                params=acc.params, segmented=True,
                                device=cuda)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    assert torch.equal(seg(x), acc(x))


# ---------------------------------------------------------------------------
# CUDA graphs per cache entry, AOT bundles and the decomposed Winograd conv
# ---------------------------------------------------------------------------

def _entry_input(acc, x):
    x = torch.from_numpy(x).to(acc.device)
    return acc.quant.quantize_input(x) if acc.quant is not None else x


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_gpu_captured_entry_equals_uncaptured(cuda, model, dtype):
    """A hopper entry's CUDA graph answers bit for bit as its uncaptured
    lowering (``entry.fn``), replays add the launches its capture
    recorded, and the first call (warm-up, then capture) launches one
    request's kernels for real."""
    build = vgg.network_specs if model == "vgg16" else resnet.resnet18_specs
    specs = build(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                dtype=dtype, device=cuda,
                                cache=ProgramCache())
    rng = np.random.default_rng(11)
    entry, params = acc.runtime.executor_entry(2, acc.input_dtype)
    assert entry.trace_count == 0
    x = _entry_input(acc, rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32))
    common.reset_launches()
    y0 = entry(params, x)
    torch.cuda.synchronize()
    per_request = {k: v for k, v in common.LAUNCHES.items() if v}
    assert per_request and entry.trace_count == 1
    assert torch.equal(y0, entry.fn(params, x))
    for seed in (12, 13):
        x = _entry_input(acc, np.random.default_rng(seed).standard_normal(
            (2, 32, 32, 3)).astype(np.float32))
        common.reset_launches()
        y = entry(params, x)
        torch.cuda.synchronize()
        assert {k: v for k, v in common.LAUNCHES.items() if v} == \
            per_request
        assert torch.equal(y, entry.fn(params, x))
    assert entry.trace_count == 1          # replays, no new capture
    # the caller owns what it gets back: a later replay leaves it alone
    keep = y.clone()
    entry(params, _entry_input(acc, rng.standard_normal(
        (2, 32, 32, 3)).astype(np.float32)))
    torch.cuda.synchronize()
    assert torch.equal(y, keep)


def test_gpu_new_weights_capture_a_new_graph(cuda):
    """Two accelerators of one program share a cache entry; the second's
    weights make the entry capture again, and neither ever replays the
    other's graph."""
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    cache = ProgramCache()
    a = api.Accelerator.build(specs, batch=2, backend="hopper", seed=0,
                              device=cuda, cache=cache)
    b = api.Accelerator.build(specs, batch=2, backend="hopper", seed=1,
                              plans=a.plans, device=cuda, cache=cache)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    ya, yb = a(x), b(x)
    entry, pa = a.runtime.executor_entry(2)
    assert b.runtime.executor_entry(2)[0] is entry
    pb = b.runtime.dram_params()
    assert entry.trace_count == 2
    for _ in range(2):
        assert torch.equal(a(x), ya) and torch.equal(b(x), yb)
    assert torch.equal(ya, entry.fn(pa, x))
    assert torch.equal(yb, entry.fn(pb, x))
    assert not torch.equal(ya, yb)
    assert entry.trace_count == 2


def test_gpu_graph_keeps_its_multipliers_past_an_eviction(cuda):
    """An int8 graph reads its requantize multipliers by address, and the
    bounded cache they came from may evict them. Cleared, with other
    tensors taking the freed memory, the replay still equals the first
    answer and the uncaptured lowering bit for bit."""
    from repro_torch.quant import execute as q_execute
    specs = vgg.network_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                dtype="int8", device=cuda,
                                cache=ProgramCache())
    entry, params = acc.runtime.executor_entry(2, acc.input_dtype)
    x = _entry_input(acc, np.random.default_rng(18).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    y0 = entry(params, x)
    assert torch.equal(entry(params, x), y0) and entry.trace_count == 1
    q_execute._layer_multiplier.cache_clear()
    junk = [torch.full((128,), 1e6, device=cuda) for _ in range(4096)]
    torch.cuda.synchronize()
    y = entry(params, x)
    torch.cuda.synchronize()
    assert entry.trace_count == 1
    assert torch.equal(y, y0) and torch.equal(y, entry.fn(params, x))
    del junk


def test_gpu_dropped_weights_drop_their_graph(cuda):
    """A graph is kept only while the weights it was captured over are
    referenced outside it: once they are gone it is dropped, and other
    weights capture a graph of their own."""
    import gc
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                device=cuda, cache=ProgramCache())
    entry, params = acc.runtime.executor_entry(2)
    x = torch.from_numpy(np.random.default_rng(19).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    y = entry(params, x)
    first = [tuple(t.clone() for t in p) for p in params]
    assert torch.equal(entry(first, x), y)
    assert entry.trace_count == 2 and len(entry._graphs) == 2
    del first
    gc.collect()
    second = [tuple(t.clone() for t in p) for p in params]
    assert torch.equal(entry(second, x), y)     # its own capture
    assert entry.trace_count == 3 and len(entry._graphs) == 2
    assert torch.equal(entry(second, x), y)
    assert torch.equal(entry(params, x), y) and entry.trace_count == 3


def test_gpu_session_buckets_replay_captured_graphs(cuda):
    """A session's bucket entries (donate_input) are captured at warmup
    and take the pinned staging buffer straight into their graph."""
    specs = vgg.network_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                device=cuda, cache=ProgramCache())
    x = np.random.default_rng(15).standard_normal(
        (4, 32, 32, 3)).astype(np.float32)
    y = acc(x).cpu().numpy()
    with acc.serve(max_batch=4, buckets=(2, 4), warmup=True) as s:
        entries = dict(s._entries)
        assert all(e.donate_input and e.trace_count == 1
                   for e in entries.values())
        assert all(st.dev is None for st in s._free_stages[4])
        out = s.run_many([x, x])
    for got in out:
        np.testing.assert_array_equal(got, y)
    assert all(e.trace_count == 1 for e in entries.values())


def test_gpu_aot_bundle_loads_and_captures(cuda, tmp_path):
    specs = vgg.network_specs(32, 16, n_classes=10)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    for dtype in ("float32", "int8"):
        acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                    dtype=dtype, device=cuda,
                                    cache=ProgramCache())
        y = acc(x)
        bundle = acc.save_program(str(tmp_path / dtype), aot=True)
        cache = ProgramCache()
        again = api.Accelerator.from_program(bundle, params=acc.params,
                                             backend="hopper", device=cuda,
                                             cache=cache)
        common.reset_launches()
        assert torch.equal(again(x), y)
        assert any(common.LAUNCHES.values())
        assert torch.equal(again(x), y)
        entry, _ = again.runtime.executor_entry(2, again.input_dtype)
        assert entry.aot_loaded and entry.trace_count == 1
        assert cache.stats.aot_loads == 1


@pytest.mark.parametrize("r,s", [(5, 5), (7, 7), (5, 3)])
@pytest.mark.parametrize("m", [2, 4])
def test_gpu_decomposed_winograd_conv(cuda, r, s, m):
    """The decomposed conv through K3 (one per piece, signed offsets), K2
    and one K4 against its plain version on the card and against the
    direct convolution."""
    from repro_torch.kernels.winograd import winograd_conv2d
    from repro_torch.kernels.winograd.ref import conv2d_ref
    g = torch.Generator(device=cuda).manual_seed(r * s + m)
    x = torch.randn(2, 19, 17, 20, device=cuda, generator=g)
    w = torch.randn(r, s, 20, 24, device=cuda, generator=g)
    b = torch.randn(24, device=cuda, generator=g)
    pieces = -(-r // 3) * -(-s // 3)
    for padding in ("SAME", "VALID"):
        common.reset_launches()
        y = winograd_conv2d(x, w, b, m=m, padding=padding, relu=True)
        torch.cuda.synchronize()
        assert common.LAUNCHES["wino_input_transform_f32"] == pieces
        assert common.LAUNCHES["bmm_f32"] == pieces
        assert common.LAUNCHES["wino_output_transform_f32"] == 1
        y_plain = winograd_conv2d(x.cpu(), w.cpu(), b.cpu(), m=m,
                                  padding=padding, relu=True)
        _gpu_close(y, y_plain.to(cuda))
        _gpu_close(y, conv2d_ref(x, w, padding, b, relu=True))


def test_gpu_concurrent_direct_calls_share_one_graph(cuda):
    """Eight threads call ``acc(x)`` at once on one stream, all through
    the direct entry's one graph (its static input and output shared):
    every result equals the single-threaded one bit for bit, and the
    counts grow by one request's launches per call."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=2, backend="hopper",
                                device=cuda, cache=ProgramCache())
    rng = np.random.default_rng(17)
    xs = [torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(
        np.float32)).to(cuda) for _ in range(16)]
    refs = [acc(x) for x in xs]
    torch.cuda.synchronize()
    common.reset_launches()
    acc(xs[0])
    torch.cuda.synchronize()
    per_call = {k: v for k, v in common.LAUNCHES.items() if v}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        common.reset_launches()
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(lambda i: [(i, acc(xs[i]).cpu())
                                           for _ in range(4)], i)
                    for i in range(16)]
            outs = [r for f in futs for r in f.result(timeout=120)]
    finally:
        sys.setswitchinterval(interval)
    for i, y in outs:
        assert torch.equal(y, refs[i].cpu())
    assert {k: v for k, v in common.LAUNCHES.items() if v} == \
        {k: 64 * v for k, v in per_call.items()}
    entry, _ = acc.runtime.executor_entry(2)
    assert entry.trace_count == 1


# ---------------------------------------------------------------------------
# F3 (graphs follow the live weight sets) and sharded serving on the card
# ---------------------------------------------------------------------------

def test_gpu_five_tenants_in_rotation_capture_once_each(cuda):
    """F3's guard: five accelerators of one fp32 program with distinct
    weights share a cache entry; called in rotation for three rounds on one
    stream, the entry captures once per weight set (5, not one a call),
    and every answer stays ``torch.equal`` to ``entry.fn`` on the same
    weights."""
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    cache = ProgramCache()
    accs = [api.Accelerator.build(specs, batch=2, backend="hopper",
                                  seed=seed, device=cuda, cache=cache)
            for seed in range(5)]
    x = torch.from_numpy(np.random.default_rng(20).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)).to(cuda)
    entry, _ = accs[0].runtime.executor_entry(2)
    for _ in range(3):
        for acc in accs:
            assert acc.runtime.executor_entry(2)[0] is entry
            y = acc(x)
            assert torch.equal(y, entry.fn(acc.runtime.dram_params(), x))
    assert entry.trace_count == 5 and len(entry._graphs) == 5


def _two_replicas(cuda):
    from repro_torch.compat import make_mesh
    return make_mesh((2,), ("batch",), devices=[cuda, cuda])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("model", ["vgg16", "resnet18"])
def test_gpu_two_replica_mesh_on_one_card(cuda, model, dtype):
    """A mesh that repeats the one card: both buckets sharded over two
    replicas, each shard replaying one graph; results equal the unsharded
    session's (int8 bit for bit, fp32 within 1e-3 max|logit|: a shard's
    GEMMs see half the rows), batches counted on both positions, and the
    launches twice a shard's per batch."""
    build = vgg.network_specs if model == "vgg16" else resnet.resnet18_specs
    specs = build(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                dtype=dtype, device=cuda,
                                cache=ProgramCache())
    reqs = list(np.random.default_rng(21).standard_normal(
        (11, 32, 32, 3)).astype(np.float32))
    with acc.serve(max_batch=4, buckets=(2, 4), warmup=True) as s:
        ref = np.stack(s.run_many(reqs))
    common.reset_launches()
    acc(np.stack(reqs[:2]))
    per_shard = {k: v for k, v in common.LAUNCHES.items() if v}
    with acc.serve(max_batch=4, buckets=(2, 4), warmup=True,
                   mesh=_two_replicas(cuda)) as s:
        assert {b: e.trace_count for b, e in
                s._sharded_entries.items()} == {2: 1, 4: 1}
        common.reset_launches()
        got = np.stack(s.run_many(reqs))
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        st = s.stats
    if dtype == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
    assert st.device_batches == {0: 3, 1: 3} and st.errors == 0
    assert launches == {k: 2 * 3 * v for k, v in per_shard.items()}


def test_gpu_fleet_over_two_replicas_bitwise(cuda):
    """Two models in a Fleet over one two-replica mesh give bit for bit
    their standalone sharded sessions' results."""
    mesh = _two_replicas(cuda)
    accs = {"v": api.Accelerator.build(vgg.network_specs(32, 16, n_classes=10),
                                       batch=4, backend="hopper",
                                       dtype="int8", device=cuda),
            "r": api.Accelerator.build(resnet.resnet18_specs(
                32, 16, n_classes=10), batch=4, backend="hopper",
                device=cuda)}
    reqs = list(np.random.default_rng(22).standard_normal(
        (8, 32, 32, 3)).astype(np.float32))
    refs = {}
    for name, acc in accs.items():
        with acc.serve(max_batch=4, buckets=(4,), mesh=mesh) as s:
            refs[name] = s.run_many(reqs)
    with api.Fleet(accs, mesh=mesh, max_batch=4, buckets=(4,)) as fleet:
        res = fleet.run_many([(n, r) for n in accs for r in reqs])
    for got, ref in zip(res, refs["v"] + refs["r"]):
        np.testing.assert_array_equal(got, ref)


def test_gpu_mesh_over_two_cards(cuda):
    """``make_fleet_mesh(2)`` over two distinct cards: each card replays
    its shard's graph on its own stream, the logits are gathered on card
    0, and the session's results equal the unsharded session's (fp32
    within 1e-3 max|logit|)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.launch.mesh import make_fleet_mesh
    specs = resnet.resnet18_specs(32, 16, n_classes=10)
    acc = api.Accelerator.build(specs, batch=4, backend="hopper",
                                device=torch.device("cuda", 0),
                                cache=ProgramCache())
    reqs = list(np.random.default_rng(23).standard_normal(
        (8, 32, 32, 3)).astype(np.float32))
    with acc.serve(max_batch=4, buckets=(4,)) as s:
        ref = np.stack(s.run_many(reqs))
    with acc.serve(max_batch=4, buckets=(4,), mesh=make_fleet_mesh(2)) as s:
        got = np.stack(s.run_many(reqs))
        entry = s._sharded_entries[4]
        assert [e.device for e in entry.shards] == ["cuda:0", "cuda:1"]
        assert entry.trace_count == 2
        assert s.stats.device_batches == {0: 2, 1: 2}
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_gpu_reduced_train_step_matches_cpu(cuda):
    """Reduced minitron-8b (fp32), three train steps on the card from the
    CPU's parameters, batch 2 x 64: each loss and grad norm within 1e-4
    relative of the CPU's (the embedding and matmul sums run in another
    order on the card); no hand-written kernel launches."""
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.optim import adamw
    from torch.utils import _pytree as pytree

    cfg = get_config("minitron-8b").reduced()
    cpu = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = pytree.tree_map(lambda t: t.to(cuda), cpu)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    step = steps.make_train_step(cfg, opt)
    data = DataConfig(cfg.vocab_size, 64, 2)
    runs = {}
    common.reset_launches()
    for name, params in (("cpu", cpu), ("cuda", dev)):
        state, out = adamw.init(params), []
        for i in range(3):
            params, state, m = step(params, state, batch_for_step(data, i))
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = out
    assert not any(common.LAUNCHES.values())
    for (loss, norm), (r_loss, r_norm) in zip(runs["cuda"], runs["cpu"]):
        assert abs(loss - r_loss) <= 1e-4 * abs(r_loss)
        assert abs(norm - r_norm) <= 1e-4 * abs(r_norm)


def test_gpu_hopper_prefill_declares_k6_work(cuda):
    """A reduced minitron-8b ``hopper`` prefill of 2048 tokens on the card
    under the roofline counter: one K6 launch a layer, each counted once at
    its declared work, and the same count as the same prefill on the CPU
    (the wrapper's plain version there is uncounted)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_work,
    )
    from repro_torch.launch import roofline
    from torch.utils import _pytree as pytree

    cfg = get_config("minitron-8b").reduced()
    cpu = steps.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 2048)).astype(np.int32))
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    counts = {}
    for dev in ("cpu", cuda):
        params = pytree.tree_map(lambda t: t.to(dev), cpu)
        common.reset_launches()
        _, counts[str(dev)] = roofline.count(
            prefill, params, tokens.to(dev),
            steps.init_cache(cfg, 2, 2048, dev))
    assert common.LAUNCHES["flash_attention"] == cfg.n_layers
    flops, nbytes = flash_attention_work(
        2 * cfg.n_heads, 2 * cfg.n_kv_heads, 2048, 2048, cfg.head_dim,
        causal=True, kv_len=2048, row_offset=0, itemsize=4)
    k6 = counts["cuda"].kernels["flash_attention"]
    assert k6 == {"launches": cfg.n_layers, "flops": cfg.n_layers * flops,
                  "bytes": cfg.n_layers * nbytes}
    assert counts["cuda"].kernels == counts["cpu"].kernels
    assert counts["cuda"].flops == counts["cpu"].flops


def test_gpu_mesh_train_over_two_cards(cuda):
    """``launch.train.build`` over a (2, 1) data mesh of two distinct
    cards: each shard runs on its card, the gradients are reduced on card
    0, and card 1 keeps a copy of the updated parameters; loss and
    parameters within 1e-4 of the one-card step (reduced minitron-8b,
    fp32)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.compat import make_mesh
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from torch.utils import _pytree as pytree

    cfg = get_config("minitron-8b").reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    p1, s1, f1, _ = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), devices=cards[:1]))
    p2, s2, f2, _ = train_mod.build(
        cfg, opt, make_mesh((2, 1), ("data", "model"), devices=cards),
        params=pytree.tree_map(lambda t: t.clone(), p1))
    batch = batch_for_step(DataConfig(cfg.vocab_size, 16, 8), 0)
    p1, s1, m1 = f1(p1, s1, batch)
    p2, s2, m2 = f2(p2, s2, batch)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-4 * abs(
        float(m1["loss"]))
    for a, b in zip(pytree.tree_leaves(p2), pytree.tree_leaves(p1)):
        assert a.device == cards[0]
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


def test_gpu_tensor_parallel_over_two_cards(cuda):
    """Reduced minitron-8b (fp32) split along ``model`` over two distinct
    cards, (1, 2): each card holds its shards; a prefill and 4 greedy
    decode steps within ``1e-5 * max(1, max|ref|)`` of the one-card run,
    and one training step (``launch.train.build``) within 1e-5 in loss
    and ``grad_norm`` and 1e-4 in the gathered parameters."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.compat import make_mesh
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from torch.utils import _pytree as pytree

    cfg = get_config("minitron-8b").reduced()
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = make_mesh((1, 2), ("data", "model"), devices=cards)
    rules = sharding.make_rules(mesh)
    params = steps.init_params(cfg, torch.Generator(device=cards[0])
                               .manual_seed(0), cards[0])
    placed = steps.place(cfg, params, rules)
    assert [t.device for t in placed["lm_head"].shards] == cards
    prefill, decode = steps.make_serve_steps(cfg)
    _, decode2 = steps.make_serve_steps(cfg, mesh=mesh)
    assert (decode.route, decode2.route) == ("captured", "eager: 2 cards")
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(cards[0])
    c1 = steps.init_cache(cfg, 4, 36, cards[0])
    with sharding.use_rules(rules):
        c2 = steps.init_cache(cfg, 4, 36, cards[0])
    l1, c1 = prefill(params, prompts, c1)
    l2, c2 = prefill(placed, prompts, c2)
    for i in range(5):
        assert l2.device == cards[0]
        assert float((l2 - l1).abs().max()) <= 1e-5 * max(
            1.0, float(l1.abs().max()))
        if i == 4:
            break
        tok = l1.argmax(-1)[:, None]
        l1, c1 = decode(params, tok, c1, 32 + i)
        l2, c2 = decode2(placed, tok, c2, 32 + i)
    assert (decode.trace_count, decode2.trace_count) == (1, 0)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    p1, s1, f1, _ = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), devices=cards[:1]),
        params=pytree.tree_map(lambda t: t.clone(), params))
    p2, s2, f2, _ = train_mod.build(cfg, opt, mesh, params=params)
    batch = batch_for_step(DataConfig(cfg.vocab_size, 16, 8), 0)
    p1, s1, m1 = f1(p1, s1, batch)
    p2, s2, m2 = f2(p2, s2, batch)
    for k in ("loss", "grad_norm"):
        assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(float(m1[k]))
    for a, b in zip(pytree.tree_leaves(sharding.gather(p2)),
                    pytree.tree_leaves(p1)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


def test_gpu_expert_parallel_over_two_cards(cuda):
    """llama4-maverick at full width cut to its first group (a dense and
    an MoE layer of 128 experts, about 37 GB of bf16 weights) split along
    ``model`` over two distinct cards, (1, 2): each card holds 64 whole
    experts, 20 of the 40 query heads and half the hidden units; a 2 x
    2048 ``hopper`` prefill (K6 on each card's heads) within ``5e-2 *
    max|logit|`` of the unsplit run on card 0, and each position's router,
    assembled from both cards, equal to the unsplit one bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import dataclasses

    from repro_torch.compat import make_mesh
    from repro_torch.models import layers, transformer
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              n_layers=2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    rules = sharding.make_rules(make_mesh((1, 2), ("data", "model"),
                                          devices=cards))
    params = steps.init_params(cfg, torch.Generator(device=cards[0])
                               .manual_seed(0), cards[0])
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2048)).astype(np.int32)).to(cards[0])
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    assert steps.make_serve_steps(cfg, mesh=rules.mesh)[1].route == \
        "eager: 2 cards"
    whole, _ = prefill(params, prompts, steps.init_cache(cfg, 2, 2048,
                                                         cards[0]))
    placed = steps.place(cfg, params, rules)
    we = placed["layers"][1]["moe"]["we_gate"]
    assert [(t.device, tuple(t.shape)) for t in we.shards] == [
        (d, (1, 64, cfg.d_model, cfg.d_ff)) for d in cards]
    for i in range(2):
        router = layers.layer_at(transformer._position_tree(
            placed, cfg, i)["layers"][1]["moe"], 0)["router"]
        assert router.device == cards[i]
        assert torch.equal(router.to(cards[0]),
                           params["layers"][1]["moe"]["router"][0])
    del params
    torch.cuda.empty_cache()
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 2048, cards[0])
    common.reset_launches()
    split, _ = prefill(placed, prompts, cache)
    assert common.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    assert split.device == cards[0]
    assert float((split.float() - whole.float()).abs().max()) <= 5e-2 * \
        float(whole.float().abs().max())


def test_gpu_zamba2_split_hopper_prefill_matches_unsplit(cuda):
    """Reduced zamba2-7b (fp32, 5 layers: 2 groups and a tail) split along
    ``model`` over (1, 2) of the repeated card: a 2 x 2048 ``hopper``
    prefill launches K6 once per group and position (4, against 2
    unsplit), on each position's 2 query heads and 1 KV head, and its
    logits hold the unsplit prefill's within ``1e-5 * max(1, max|ref|)``."""
    import dataclasses

    from repro_torch.compat import make_mesh
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_config("zamba2-7b").reduced(), n_layers=5)
    rules = sharding.make_rules(make_mesh((1, 2), ("data", "model"),
                                          devices=[cuda, cuda]))
    params = steps.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2048)).astype(np.int32)).to(cuda)
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    common.reset_launches()
    whole, _ = prefill(params, prompts, steps.init_cache(cfg, 2, 2048, cuda))
    assert common.LAUNCHES["flash_attention"] == 2
    placed = steps.place(cfg, params, rules)
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 2048, cuda)
    common.reset_launches()
    split, _ = prefill(placed, prompts, cache)
    assert common.LAUNCHES["flash_attention"] == 4
    assert torch.isfinite(split).all()
    assert float((split - whole).abs().max()) <= 1e-5 * max(
        1.0, float(whole.abs().max()))


def test_gpu_straddling_share_runs_k6_against_its_plain_version(cuda):
    """48 query heads over 8 KV heads split over 6 positions of the
    repeated card (reduced internlm2-20b, fp32, head dim 16): each
    position's 8 heads straddle two KV groups. Position 1's attention on
    ``hopper`` (heads [8, 16) over KV heads [1, 3), ``q_offset`` 2) at
    2048 tokens launches K6 once, and its output holds the same call on
    the CPU, where the wrapper runs K6's plain version, within ``1e-4 *
    max(1, max|ref|)``; a 2 x 2048 ``hopper`` prefill of the split model
    launches K6 once per layer and position and its logits hold the
    unsplit prefill's within ``1e-5 * max(1, max|ref|)``."""
    import dataclasses

    from repro_torch.compat import make_mesh
    from repro_torch.models import layers, transformer
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_config("internlm2-20b").reduced(),
                              n_heads=48, n_kv_heads=8)
    n = 6
    rules = sharding.make_rules(make_mesh((1, n), ("data", "model"),
                                          devices=[cuda] * n))
    params = steps.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    placed = steps.place(cfg, params, rules)
    r = layers._tp_ranges(cfg, n, 1)
    assert (r["heads"], r["kv_heads"], r["q_offset"]) == ((8, 16), (1, 3), 2)
    attn = layers.layer_at(transformer._position_tree(placed, cfg, 1)[
        "layers"][0]["attn"], 0)
    x = torch.randn(2, 2048, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))
    common.reset_launches()
    out, _ = layers.attention(attn, x, cfg, q_offset=2, backend="hopper")
    assert common.LAUNCHES["flash_attention"] == 1
    ref, _ = layers.attention({k: t.cpu() for k, t in attn.items()},
                              x.cpu(), cfg, q_offset=2, backend="hopper")
    _gpu_close(out.cpu(), ref)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2048)).astype(np.int32)).to(cuda)
    prefill, _ = steps.make_serve_steps(cfg, backend="hopper")
    whole, _ = prefill(params, prompts, steps.init_cache(cfg, 2, 2048, cuda))
    with sharding.use_rules(rules):
        cache = steps.init_cache(cfg, 2, 2048, cuda)
    common.reset_launches()
    split, _ = prefill(placed, prompts, cache)
    assert common.LAUNCHES["flash_attention"] == n * cfg.n_layers
    assert torch.isfinite(split).all()
    assert float((split - whole).abs().max()) <= 1e-5 * max(
        1.0, float(whole.abs().max()))


def test_gpu_ssm_hybrid_audio_tensor_parallel_over_two_cards(cuda):
    """Reduced mamba2-130m, zamba2-7b (5 layers) and whisper-base (fp32)
    split along ``model`` over two distinct cards, (1, 2): each card holds
    its shards; a prefill and 4 greedy decode steps within ``1e-5 *
    max(1, max|ref|)`` of the one-card run (whisper encodes over both
    cards), and one training step (``launch.train.build``) within 1e-5 in
    loss and ``grad_norm`` and, by ``adamw.step_gaps``, each gradient leaf
    within 1e-4 of its own max|g|, the parameters within 1e-4 wherever the
    gradient is well above AdamW's eps, every element the one-card step
    moved moved."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    import dataclasses
    from unittest import mock

    from repro_torch.compat import make_mesh
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch import train as train_mod
    from repro_torch.models import whisper
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from torch.utils import _pytree as pytree

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = make_mesh((1, 2), ("data", "model"), devices=cards)
    rules = sharding.make_rules(mesh)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    for arch, n_layers in (("mamba2-130m", None), ("zamba2-7b", 5),
                           ("whisper-base", None)):
        cfg = get_config(arch).reduced()
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        params = steps.init_params(cfg, torch.Generator(device=cards[0])
                                   .manual_seed(0), cards[0])
        placed = steps.place(cfg, params, rules)
        assert [t.device for t in placed["lm_head"].shards] == cards
        extras = {k: v.to(cards[0]) for k, v in train_mod.extras_for(
            cfg, 4, np.random.default_rng(1)).items()}
        serve_extras = [{}, {}]
        if "frames" in extras:
            with torch.no_grad():
                serve_extras = [{"enc_out": whisper.encode(
                    p, extras["frames"], cfg)} for p in (params, placed)]
        prefill, decode = steps.make_serve_steps(cfg)
        _, decode2 = steps.make_serve_steps(cfg, mesh=mesh)
        assert decode2.route == "eager: 2 cards"
        prompts = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32)).to(cards[0])
        c1 = steps.init_cache(cfg, 4, 36, cards[0])
        with sharding.use_rules(rules):
            c2 = steps.init_cache(cfg, 4, 36, cards[0])
        l1, c1 = prefill(params, prompts, c1, serve_extras[0])
        l2, c2 = prefill(placed, prompts, c2, serve_extras[1])
        for i in range(5):
            assert l2.device == cards[0]
            assert float((l2 - l1).abs().max()) <= 1e-5 * max(
                1.0, float(l1.abs().max())), arch
            if i == 4:
                break
            tok = l1.argmax(-1)[:, None]
            l1, c1 = decode(params, tok, c1, 32 + i, serve_extras[0])
            l2, c2 = decode2(placed, tok, c2, 32 + i, serve_extras[1])
        assert decode2.trace_count == 0
        p1, s1, f1, _ = train_mod.build(
            cfg, opt, make_mesh((1, 1), ("data", "model"),
                                devices=cards[:1]),
            params=pytree.tree_map(lambda t: t.clone(), params))
        p2, s2, f2, _ = train_mod.build(cfg, opt, mesh, params=params)
        batch = batch_for_step(DataConfig(cfg.vocab_size, 16, 8), 0)
        batch.update(train_mod.extras_for(cfg, 8, np.random.default_rng(2)))
        seen, update = [], adamw.update

        def spy(opt_cfg, grads, state, p):
            seen.append(sharding.gather(pytree.tree_map(
                lambda t: t.clone(), grads)))
            return update(opt_cfg, grads, state, p)
        with mock.patch.object(adamw, "update", spy):
            p1, s1, m1 = f1(p1, s1, batch)
            p2, s2, m2 = f2(p2, s2, batch)
        for k in ("loss", "grad_norm"):
            assert abs(float(m2[k]) - float(m1[k])) <= 1e-5 * abs(
                float(m1[k])), arch
        gaps = adamw.step_gaps(opt, params, seen[1], sharding.gather(p2),
                               seen[0], p1)
        assert gaps["grad"] <= 1e-4 and gaps["param"] <= 1e-4, (arch, gaps)
        assert gaps["unmoved"] == 0, (arch, gaps)


# ---------------------------------------------------------------------------
# the decode step captured as a CUDA graph (``train.steps.DecodeStep``)
# ---------------------------------------------------------------------------

DECODE_ARCHS = ("minitron-8b", "llama4-scout-17b-16e", "llama-3.2-vision-11b",
                "mamba2-130m", "zamba2-7b", "whisper-base")


def _decode_model(arch: str, device, mesh=None):
    """A reduced fp32 model (a VLM's gates open), its extras and 2 x 8
    prompts from seed 0, placed over ``mesh`` of the repeated card when
    given; and the rules to build its caches under (None unsplit)."""
    from repro_torch.compat import make_mesh
    from repro_torch.models import whisper
    from repro_torch.parallel import sharding

    cfg = get_config(arch).reduced()
    params = steps.init_params(cfg, torch.Generator(device=device)
                               .manual_seed(0), device)
    rng = np.random.default_rng(0)
    extras = {}
    if cfg.family == "vlm":
        for slot in params["layers"]:
            if "xattn_gate" in slot:
                slot["xattn_gate"].fill_(0.5)
        extras["image_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)).to(
                device)
    if cfg.family == "audio":
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)).to(
                device)
        with torch.no_grad():
            extras["enc_out"] = whisper.encode(params, frames, cfg)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                            dtype=np.int32)).to(device)
    rules = None
    if mesh is not None:
        rules = sharding.make_rules(make_mesh(
            mesh, ("data", "model"), devices=[device] * (mesh[0] * mesh[1])))
        params = steps.place(cfg, params, rules)
    return cfg, params, extras, prompts, rules


@pytest.mark.parametrize("arch,mesh", [
    *((a, None) for a in DECODE_ARCHS), ("minitron-8b", (1, 2)),
    ("minitron-8b", (2, 2))])
def test_gpu_captured_decode_equals_its_eager_step(cuda, arch, mesh):
    """Four greedy decode steps through the step object (the first runs
    ``fn`` and captures, the other three replay) against four through its
    eager ``fn`` on a second cache from the same prefill: the logits at
    every step ``torch.equal``, so the tokens too; one capture, one graph
    (unsplit, and the dense model split over (1, 2) and (2, 2) of the
    repeated card, captured whole on its stream)."""
    from repro_torch.parallel import sharding

    cfg, params, extras, prompts, rules = _decode_model(arch, cuda, mesh)
    prefill, decode = steps.make_serve_steps(cfg)
    assert decode.route == "captured"
    runs = []
    for captured in (True, False):
        with sharding.use_rules(rules):
            cache = steps.init_cache(cfg, 2, 12, cuda)
        logits, cache = prefill(params, prompts, cache, extras)
        got = []
        for i in range(4):
            tok = logits.argmax(-1)[:, None]
            if captured:
                logits, cache = decode(params, tok, cache, 8 + i, extras)
            else:
                logits, cache = decode.fn(params, tok, cache,
                                          torch.tensor(8 + i, device=cuda),
                                          extras)
            got.append(logits)
        runs.append(got)
    assert (decode.trace_count, len(decode._graphs)) == (1, 1)
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), (arch, mesh, i,
                                   float((a - b).abs().max()))


def test_gpu_decode_graph_of_a_freed_cache_is_never_replayed(cuda):
    """Two requests of reduced minitron-8b through one step object, each
    with its own cache, the first freed before the second is allocated
    (the allocator hands its blocks back: the caches share addresses):
    the second captures anew (two captures), the first's graph is gone
    (one graph), and both requests' logits equal, bit for bit."""
    from torch.utils import _pytree as pytree

    cfg, params, _, prompts, _ = _decode_model("minitron-8b", cuda)
    prefill, decode = steps.make_serve_steps(cfg)

    def request():
        cache = steps.init_cache(cfg, 2, 12, cuda)
        logits, cache = prefill(params, prompts, cache)
        out = []
        for i in range(3):
            logits, cache = decode(params, logits.argmax(-1)[:, None],
                                   cache, 8 + i)
            out.append(logits)
        return out, {t.data_ptr() for t in pytree.tree_leaves(cache)}

    first, ptrs = request()
    torch.cuda.synchronize()
    second, again = request()
    assert ptrs & again
    assert (decode.trace_count, len(decode._graphs)) == (2, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# ---------------------------------------------------------------------------
# the captured train step (``steps.TrainStep``)
# ---------------------------------------------------------------------------

TRAIN_ARCHS = ["minitron-8b", "llama4-scout-17b-16e", "llama-3.2-vision-11b",
               "mamba2-130m", "zamba2-7b", "whisper-base"]


def _train_batches(cfg, n: int, rows: int = 4, seq: int = 32) -> list:
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import extras_for

    data = DataConfig(cfg.vocab_size, seq, rows)
    out = []
    for i in range(n):
        b = batch_for_step(data, i)
        b.update(extras_for(cfg, rows, np.random.default_rng(i)))
        out.append(b)
    return out


def _train_run(step, params, state, batches) -> list:
    """Each step's parameters, state and metrics (copies)."""
    from torch.utils import _pytree as pytree

    out = []
    for b in batches:
        params, state, m = step(params, state, b)
        out.append([t.clone() for t in pytree.tree_leaves(
            (params, state, m))])
    return out


@pytest.mark.parametrize("arch,mesh", [
    *((a, (1, 1)) for a in TRAIN_ARCHS), ("minitron-8b", (2, 1)),
    ("minitron-8b", (1, 2)), ("mamba2-130m", (2, 2))])
def test_gpu_captured_train_step_equals_its_eager_fn(cuda, arch, mesh):
    """Reduced configs in fp32 through ``launch.train.build`` (whole, and
    over data rows or ``model`` positions of the repeated card): three
    steps through the step object (the first runs ``fn`` and captures, two
    replay) against three through its eager ``fn`` twice, each from copies
    of the same parameters and state. Where the two eager runs are bit
    identical the captured one equals them bit for bit; else every
    parameter within 1e-4 of max(1, max|p|) and loss and grad norm within
    1e-5 relative (the mesh step's limits). One capture, one graph, and
    AdamW's ``step`` at 3."""
    from repro_torch.compat import make_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from torch.utils import _pytree as pytree

    cfg = get_config(arch).reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    m = make_mesh(mesh, ("data", "model"), devices=[cuda] * (mesh[0] *
                                                             mesh[1]))
    params, state, step, _ = train_mod.build(cfg, opt, m)
    assert step.route == "captured"
    batches = _train_batches(cfg, 3)
    copies = [pytree.tree_map(lambda t: t.clone(), (params, state))
              for _ in range(2)]
    eager = [_train_run(step.fn, *c, batches) for c in copies]
    got = _train_run(step, params, state, batches)
    assert (step.trace_count, len(step._graphs)) == (1, 1)
    assert int(state["step"]) == 3
    bitwise = all(torch.equal(a, b) for x, y in zip(*eager)
                  for a, b in zip(x, y))
    for i, (x, y) in enumerate(zip(got, eager[0])):
        assert len(x) == len(y)
        if bitwise:
            assert all(torch.equal(a, b) for a, b in zip(x, y)), i
            continue
        for a, b in zip(x[:-3], y[:-3]):
            assert float((a.float() - b.float()).abs().max()) <= 1e-4 * max(
                1.0, float(b.float().abs().max())), i
        for a, b in zip(x[-3:], y[-3:]):
            assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b)), i


def test_gpu_train_step_captures_once_per_parameter_set(cuda):
    """Two parameter sets of reduced minitron-8b taking turns through one
    step object: each captures once (two captures, two graphs), every
    later call replays its own, and each set's AdamW ``step`` counts its
    own calls; each set's losses equal those of a step object that saw
    only that set, bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    cfg = get_config("minitron-8b").reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    batches = _train_batches(cfg, 3)
    sets, alone, step = [], [], None
    for seed in (0, 1):
        p, s, built, _ = train_mod.build(cfg, opt, make_host_mesh("cuda"),
                                         seed=seed)
        sets.append([p, s])
        step = step or built               # the first set's step object
        p2, s2, own, _ = train_mod.build(cfg, opt, make_host_mesh("cuda"),
                                         seed=seed)
        alone.append([float(m[-3]) for m in _train_run(own, p2, s2,
                                                       batches)])
    losses = [[], []]
    for b in batches:
        for i, (p, s) in enumerate(sets):
            p, s, m = step(p, s, b)
            losses[i].append(float(m["loss"]))
    assert (step.trace_count, len(step._graphs)) == (2, 2)
    assert [int(s["step"]) for _, s in sets] == [3, 3]
    assert losses == alone


def test_gpu_restored_parameters_capture_anew(cuda, tmp_path):
    """Reduced minitron-8b: three captured steps, a checkpoint, the
    parameters and state restored from it (new tensors) and the old ones
    dropped, three more steps through the same step object: the restored
    set warms up and captures anew, the dead set's graph is gone (two
    captures, one graph), and the six losses equal an uninterrupted run's
    within 1e-5 relative."""
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw

    cfg = get_config("minitron-8b").reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    batches = _train_batches(cfg, 6)
    p, s, whole, _ = train_mod.build(cfg, opt, make_host_mesh("cuda"))
    want = [float(m[-3]) for m in _train_run(whole, p, s, batches)]
    del p, s, whole
    p, s, step, _ = train_mod.build(cfg, opt, make_host_mesh("cuda"))
    got = [float(m[-3]) for m in _train_run(step, p, s, batches[:3])]
    ckpt.save(str(tmp_path), 3, (p, s))
    template = (p, s)
    del p, s
    (p, s), at = ckpt.restore(str(tmp_path), template, device=cuda)
    del template
    assert at == 3
    got += [float(m[-3]) for m in _train_run(step, p, s, batches[3:])]
    assert (step.trace_count, len(step._graphs)) == (2, 1)
    assert int(s["step"]) == 6
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-5 * abs(b)


def test_gpu_train_step_over_two_cards_stays_eager(cuda):
    """Over a (1, 2) mesh of two distinct cards the step's route is
    ``"eager: 2 cards"``: it runs ``fn`` (no capture), and its loss
    equals the one-card captured step's within 1e-5 relative."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    from repro_torch.compat import make_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.optim import adamw
    from torch.utils import _pytree as pytree

    cfg = get_config("minitron-8b").reduced()
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    p1, s1, f1, _ = train_mod.build(
        cfg, opt, make_mesh((1, 1), ("data", "model"), devices=cards[:1]))
    p2, s2, f2, _ = train_mod.build(
        cfg, opt, make_mesh((1, 2), ("data", "model"), devices=cards),
        params=pytree.tree_map(lambda t: t.clone(), p1))
    assert (f1.route, f2.route) == ("captured", "eager: 2 cards")
    for b in _train_batches(cfg, 2):
        p1, s1, m1 = f1(p1, s1, b)
        p2, s2, m2 = f2(p2, s2, b)
        assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(
            float(m1["loss"]))
    assert (f1.trace_count, f2.trace_count) == (1, 0)
