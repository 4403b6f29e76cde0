"""The plain reference against ``torch.nn.functional`` written out by hand,
and its TF32 control."""
import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import net
from bench.yardstick import inputs, work


def _conv(name, h, c, k, r, stride, **kw):
    return dict(kind="conv", name=name, h=h, w=h, c=c, k=k, r=r, s=r,
                stride=stride, padding="SAME", relu=kw.get("relu", True),
                **{k2: v for k2, v in kw.items() if k2 != "relu"})


def test_reference_against_functional():
    g = torch.Generator().manual_seed(0)
    layers = [
        _conv("c0", 8, 3, 4, 3, 1),
        {"kind": "pool", "name": "p0", "h": 8, "w": 8, "c": 4, "window": 2,
         "stride": 2},
        _conv("c1", 4, 4, 6, 3, 2),
        _conv("c2", 2, 6, 6, 1, 1, relu=False),
        {"kind": "fc", "name": "f0", "d_in": 24, "d_out": 5, "relu": False},
    ]
    shapes = [(3, 3, 3, 4), (3, 3, 4, 6), (1, 1, 6, 6), (24, 5)]
    weights = [(torch.randn(s, generator=g), torch.randn(s[-1], generator=g))
               for s in shapes]
    x = torch.randn(2, 8, 8, 3, generator=g)

    def conv(t, wb, pads, stride):
        w, b = wb
        t = F.pad(t.permute(0, 3, 1, 2), pads)
        return F.conv2d(t, w.permute(3, 2, 0, 1), b,
                        stride=stride).permute(0, 2, 3, 1)
    y0 = torch.relu(conv(x, weights[0], (1, 1, 1, 1), 1))
    y1 = F.max_pool2d(y0.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    y2 = torch.relu(conv(y1, weights[1], (0, 1, 0, 1), 2))  # TF SAME, even
    y3 = conv(y2, weights[2], (0, 0, 0, 0), 1)
    want = y3.reshape(2, -1) @ weights[3][0] + weights[3][1]
    got = net.forward(layers, weights, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # in blocks, from host arrays
    blocks = net.logits(layers, weights, x.numpy(), "cpu", block=1)
    np.testing.assert_allclose(blocks, want.numpy(), rtol=1e-5, atol=1e-5)


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def test_residual_table_against_functional():
    """Inputs rerouted by ``from``, an add by ``skip``: a padded 3x3/2 max
    pool, a block whose 1x1/2 projection and first conv both read the
    pool, and an explicit-pad conv."""
    g = torch.Generator().manual_seed(1)
    layers = [
        dict(_conv("stem", 8, 3, 4, 3, 1), padding=[[2, 0], [1, 1]]),
        {"kind": "pool", "name": "p0", "h": 8, "w": 8, "c": 4, "window": 3,
         "stride": 2, "pad": 1},
        dict(_conv("proj", 4, 4, 6, 1, 2, relu=False), padding="VALID",
             **{"from": "p0"}),
        dict(_conv("c1", 4, 4, 6, 3, 2), **{"from": "p0"}),
        _conv("c2", 2, 6, 6, 3, 1, relu=False),
        {"kind": "add", "name": "add", "h": 2, "w": 2, "c": 6,
         "skip": "proj", "relu": True},
        {"kind": "fc", "name": "f0", "d_in": 24, "d_out": 5, "relu": False},
    ]
    shapes = [(3, 3, 3, 4), (1, 1, 4, 6), (3, 3, 4, 6), (3, 3, 6, 6),
              (24, 5)]
    assert [s for s, _ in inputs.weight_shapes(layers)] == shapes
    weights = [(torch.randn(s, generator=g), torch.randn(s[-1], generator=g))
               for s in shapes]
    x = torch.randn(2, 8, 8, 3, generator=g)

    def conv(t, wb, pads, stride):
        w, b = wb
        return _nhwc(F.conv2d(F.pad(_nchw(t), pads), w.permute(3, 2, 0, 1),
                              b, stride=stride))
    stem = torch.relu(conv(x, weights[0], (1, 1, 2, 0), 1))
    pool = _nhwc(F.max_pool2d(_nchw(stem), 3, 2, padding=1))
    proj = conv(pool, weights[1], (0, 0, 0, 0), 2)
    c1 = torch.relu(conv(pool, weights[2], (0, 1, 0, 1), 2))
    c2 = conv(c1, weights[3], (1, 1, 1, 1), 1)
    y = torch.relu(c2 + proj)
    want = y.reshape(2, -1) @ weights[4][0] + weights[4][1]
    assert pool.shape[1:3] == (4, 4) == work.out_hw(layers[1])
    torch.testing.assert_close(net.forward(layers, weights, x), want,
                               rtol=1e-5, atol=1e-5)


def test_depthwise_table_against_functional():
    g = torch.Generator().manual_seed(2)
    dw = dict(kind="depthwise", name="d0", h=8, w=8, c=4, r=3, s=3,
              stride=2, padding="SAME", relu=True)
    layers = [
        _conv("c0", 8, 3, 4, 3, 1),
        dw,
        dict(dw, name="d1", h=4, w=4, stride=1, padding=[[0, 2], [1, 0]],
             relu=False),
        {"kind": "fc", "name": "f0", "d_in": 4 * 3 * 4, "d_out": 3,
         "relu": False},
    ]
    shapes = [(3, 3, 3, 4), (3, 3, 1, 4), (3, 3, 1, 4), (48, 3)]
    assert inputs.weight_shapes(layers) == [
        ((3, 3, 3, 4), 27), ((3, 3, 1, 4), 9), ((3, 3, 1, 4), 9),
        ((48, 3), 48)]
    weights = [(torch.randn(s, generator=g), torch.randn(s[-1], generator=g))
               for s in shapes]
    x = torch.randn(2, 8, 8, 3, generator=g)

    def conv(t, wb, pads, stride, groups=1):
        w, b = wb
        return _nhwc(F.conv2d(F.pad(_nchw(t), pads), w.permute(3, 2, 0, 1),
                              b, stride=stride, groups=groups))
    y0 = torch.relu(conv(x, weights[0], (1, 1, 1, 1), 1))
    y1 = torch.relu(conv(y0, weights[1], (0, 1, 0, 1), 2, groups=4))
    y2 = conv(y1, weights[2], (1, 0, 0, 2), 1, groups=4)
    assert y2.shape[1:3] == (4, 3) == work.out_hw(layers[2])
    want = y2.reshape(2, -1) @ weights[3][0] + weights[3][1]
    torch.testing.assert_close(net.forward(layers, weights, x), want,
                               rtol=1e-5, atol=1e-5)


def test_same_pads_follow_tensorflow():
    assert net.same_pads(8, 3, 1) == (1, 1)
    assert net.same_pads(8, 3, 2) == (0, 1)
    assert net.same_pads(7, 3, 2) == (1, 1)
    assert net.same_pads(8, 1, 2) == (0, 0)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.14159, 0.0])
    r = net.round_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()
    # ties to even: 1 + 2^-11 lies halfway between 1 and 1 + 2^-10
    assert r[1].item() == 1.0
    assert r[2].item() == 1.0 + 2 * 2 ** -10
    assert r[3].item() == 1.0
    assert abs(r[4].item() + 3.14159) <= 3.14159 * 2 ** -11
    assert r[5].item() == 0.0


def test_reference_sets_no_tf32_and_restores():
    before = torch.backends.cuda.matmul.allow_tf32
    seen = []
    with net.plain_float32():
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        seen.append(torch.backends.cudnn.allow_tf32)
        seen.append(torch.backends.cudnn.enabled)
    assert seen == [False, False, False]
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_reference_imports_nothing_of_the_program():
    import ast
    from bench_tiny import ROOT
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names
                    if n.split(".")[0] in ("repro_torch", "repro", "jax")], \
            path
