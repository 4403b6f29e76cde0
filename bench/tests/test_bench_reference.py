"""The plain reference against ``torch.nn.functional`` written out by hand,
and its TF32 control."""
import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import net


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
