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
``backend="torch"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.compiler import LayerPlan  # noqa: E402
from repro_torch.core.runtime import HybridRuntime  # noqa: E402
from repro_torch.core.hybrid_conv import (  # noqa: E402
    ConvSpec,
    DepthwiseSpec,
    FCSpec,
    PoolSpec,
)
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.gemm.int8 import qmm_i8, qmm_ref  # noqa: E402
from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref  # noqa: E402
from repro_torch.kernels.spatial_conv.kernel import (  # noqa: E402
    conv_gemm_f32,
    conv_gemm_ref,
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
from repro_torch.models import resnet, vgg  # noqa: E402
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
    before = common.LAUNCHES["conv_gemm_f32"]
    for relu, df in [(True, "is"), (False, "ws")]:
        _gpu_close(conv_gemm_f32(p, w, b, relu, df),
                   conv_gemm_ref(p, w, b, relu, df))
        assert common.last_route("conv_gemm_f32") == route
    assert common.LAUNCHES["conv_gemm_f32"] == before + 2


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
