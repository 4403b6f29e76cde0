"""On a CUDA card only: each hand-written kernel against its plain PyTorch
version, and the port's whole ``hopper`` path against its ``torch`` path.

This file imports neither JAX nor the reference package, so it runs on a
card host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py

Every case carries the ``gpu`` marker and skips without a card. Tolerance:
``1e-4 * max(1, max|ref|)`` per kernel (fp32 sums taken in another order),
``1e-4 * max|logit|`` on the reduced-VGG16 logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api  # noqa: E402
from repro_torch.core.compiler import LayerPlan  # noqa: E402
from repro_torch.core.hybrid_conv import ConvSpec  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.gemm.kernel import bmm_f32, bmm_ref  # noqa: E402
from repro_torch.kernels.spatial_conv.kernel import (  # noqa: E402
    conv_gemm_f32,
    conv_gemm_ref,
)
from repro_torch.kernels.winograd.kernel import (  # noqa: E402
    wino_input_transform_f32,
    wino_input_transform_ref,
    wino_output_transform_f32,
    wino_output_transform_ref,
)
from repro_torch.models import vgg  # noqa: E402

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


@pytest.mark.parametrize("t,crs,k", [(37, 5, 3), (1000, 27, 64),
                                     (300, 1152, 130)])
def test_gpu_conv_gemm(cuda, t, crs, k):
    p, w, b = (torch.randn(*s, device=cuda) for s in ((t, crs), (crs, k), (k,)))
    before = common.LAUNCHES["conv_gemm_f32"]
    for relu, df in [(True, "is"), (False, "ws")]:
        _gpu_close(conv_gemm_f32(p, w, b, relu, df),
                   conv_gemm_ref(p, w, b, relu, df))
    assert common.LAUNCHES["conv_gemm_f32"] == before + 2


@pytest.mark.parametrize("g,m,k,n", [(2, 5, 3, 7), (36, 392, 256, 512),
                                     (1, 8, 4096, 1000), (1, 17, 9, 65)])
def test_gpu_bmm(cuda, g, m, k, n):
    a, b, bias = (torch.randn(*s, device=cuda)
                  for s in ((g, m, k), (g, k, n), (g, n)))
    _gpu_close(bmm_f32(a, b), bmm_ref(a, b))
    _gpu_close(bmm_f32(a, b, bias, True, "ws"), bmm_ref(a, b, bias, True))
    a_off = _misaligned(g, m, k, device=cuda)
    _gpu_close(bmm_f32(a_off, b, bias), bmm_ref(a_off, b, bias))


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
    assert all(common.LAUNCHES.values())
    y, y_ref = y.cpu().numpy(), ref(x).cpu().numpy()
    assert np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= 1e-4 * np.abs(y_ref).max()
