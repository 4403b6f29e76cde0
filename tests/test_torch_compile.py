"""The port's compile side against the reference, bit for bit: ISA words,
Winograd matrices, DSE plans, instruction images, schedule keys and the
seeded random parameters."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as r_api  # noqa: E402
from repro.core import compiler as r_compiler  # noqa: E402
from repro.core import isa as r_isa  # noqa: E402
from repro.core import perf_model as r_pm  # noqa: E402
from repro.core import winograd as r_wino  # noqa: E402
from repro.models import vgg as r_vgg  # noqa: E402
from repro_torch import api as t_api  # noqa: E402
from repro_torch.core import compiler as t_compiler  # noqa: E402
from repro_torch.core import isa as t_isa  # noqa: E402
from repro_torch.core import perf_model as t_pm  # noqa: E402
from repro_torch.core import winograd as t_wino  # noqa: E402
from repro_torch.models import vgg as t_vgg  # noqa: E402

TARGETS = ["V5E", "VU9P", "PYNQ_Z1"]
SIZES = {"reduced": (32, 32, 10), "full": (224, 1, 1000)}


def _specs(size):
    img, scale, n_classes = SIZES[size]
    return (r_vgg.network_specs(img, scale, n_classes=n_classes),
            t_vgg.network_specs(img, scale, n_classes=n_classes))


def _plan_tuple(p):
    return None if p is None else dataclasses.astuple(p)


def _random_instruction(rng, opcode: int) -> dict:
    fields = dict(
        opcode=opcode, wino_flag=bool(rng.integers(2)),
        dataflow_ws=bool(rng.integers(2)),
        layout_out_wino=bool(rng.integers(2)), relu_flag=bool(rng.integers(2)),
        layer_id=int(rng.integers(1 << 16)),
        buff_base=int(rng.integers(1 << 32)),
        dram_base=int(rng.integers(1 << 32)), size=int(rng.integers(1 << 32)))
    if opcode == int(r_isa.Opcode.POOL):
        fields.update(pool_window=int(rng.integers(16)),
                      pool_stride=int(rng.integers(16)))
    else:
        fields.update(m_tile=int(rng.integers(256)))
    return fields


@pytest.mark.parametrize("opcode", [int(o) for o in r_isa.Opcode])
def test_isa_words_match_reference(opcode):
    rng = np.random.default_rng(opcode)
    for _ in range(50):
        f = _random_instruction(rng, opcode)
        r_ins = r_isa.Instruction(**{**f, "opcode": r_isa.Opcode(opcode)})
        t_ins = t_isa.Instruction(**{**f, "opcode": t_isa.Opcode(opcode)})
        words = t_ins.encode()
        np.testing.assert_array_equal(words, r_ins.encode())
        back = t_isa.decode(words)
        assert dataclasses.astuple(back)[1:] == \
            dataclasses.astuple(r_isa.decode(words))[1:]
        assert int(back.opcode) == opcode


def test_isa_dims_and_reserved_opcodes():
    rng = np.random.default_rng(7)
    for r, s, st in rng.integers(1, 256, size=(200, 3)):
        packed = t_isa.pack_dw_geom(int(r), int(s), int(st))
        assert packed == r_isa.pack_dw_geom(int(r), int(s), int(st))
        assert t_isa.unpack_dw_geom(packed) == (r, s, st)
    for bad in [(0, 3, 1), (3, 0, 1), (3, 3, 0), (256, 3, 1)]:
        with pytest.raises(ValueError):
            t_isa.pack_dw_geom(*bad)
    assert t_isa.pack_fc_dims(25088, 4096) == r_isa.pack_fc_dims(25088, 4096)
    with pytest.raises(ValueError):
        t_isa.pack_fc_dims(100352, 1000)    # full ResNet-18's FC width
    for code in (0, 10, 15):
        with pytest.raises(ValueError, match="reserved"):
            t_isa.decode(np.array([code, 0, 0, 0], np.uint32))


@pytest.mark.parametrize("m", [2, 4])
def test_winograd_matrices_exact(m):
    for dtype in (np.float32, np.float64):
        for a, b in zip(t_wino.transform_matrices(m, dtype),
                        r_wino.transform_matrices(m, dtype)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert t_wino.pt_for(m) == r_wino.pt_for(m)
    assert t_wino.SUPPORTED_M == r_wino.SUPPORTED_M


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("target", TARGETS)
def test_dse_plans_match_reference(target, batch, size):
    r_specs, t_specs = _specs(size)
    r_res = getattr(r_pm, target).run_dse(r_specs, batch=batch)
    t_res = getattr(t_pm, target).run_dse(t_specs, batch=batch)
    assert [_plan_tuple(p) for p in t_res.plans] == \
        [_plan_tuple(p) for p in r_res.plans]
    assert dataclasses.astuple(t_res.hw) == dataclasses.astuple(r_res.hw)
    assert t_res.total_latency == r_res.total_latency
    assert t_res.candidates_searched == r_res.candidates_searched


def _hand_plans(specs, m):
    """Multi-group plans: g_h/g_k > 1, Winograd at tile m on even CONVs."""
    plans, ci = [], 0
    for s in specs:
        if type(s).__name__ != "ConvSpec":
            plans.append(None)
            continue
        mode = "wino" if ci % 2 == 0 else "spat"
        plans.append((mode, "ws" if ci % 3 == 0 else "is", m,
                      1 + ci % 3, 1 + (ci + 1) % 4))
        ci += 1
    return plans


@pytest.mark.parametrize("case", ["reduced-dse", "full-dse", "reduced-hand-2",
                                  "reduced-hand-4", "full-hand-4"])
def test_program_image_and_schedule_key_match(case):
    size, kind = case.split("-", 1)
    r_specs, t_specs = _specs(size)
    if kind == "dse":
        plans = [_plan_tuple(p) for p in
                 r_pm.V5E.run_dse(r_specs, batch=8).plans]
    else:
        plans = _hand_plans(r_specs, int(kind.split("-")[1]))
    r_prog = r_compiler.compile_network(
        r_specs, [None if p is None else r_compiler.LayerPlan(*p)
                  for p in plans])
    t_prog = t_compiler.compile_network(
        t_specs, [None if p is None else t_compiler.LayerPlan(*p)
                  for p in plans])
    np.testing.assert_array_equal(t_prog.instruction_image(),
                                  r_prog.instruction_image())
    assert t_prog.schedule_key() == r_prog.schedule_key()
    assert t_prog.dram_size_words == r_prog.dram_size_words


def test_full_vgg16_program_shape():
    """The served configuration: 101 instructions, 16 COMP, 5 POOL, 3 FC,
    with SAVE writing the tile-major WINO layout ahead of every Winograd
    CONV (conv0 -> conv1, pool2 -> conv7 -> conv8 -> conv9)."""
    _, t_specs = _specs("full")
    prog = t_compiler.compile_network(
        t_specs, t_pm.V5E.run_dse(t_specs, batch=8).plans)
    ops = [ins.opcode for ins in prog.instructions]
    assert len(ops) == 101
    assert ops.count(t_isa.Opcode.COMP) == 16
    assert ops.count(t_isa.Opcode.POOL) == 5
    assert ops.count(t_isa.Opcode.FC) == 3
    modes = [cl.plan.mode for cl in prog.layers if cl.kind == "conv"]
    assert [i for i, m in enumerate(modes) if m == "wino"] == [1, 7, 8, 9]
    assert [cl.layer_id for cl in prog.layers if cl.out_layout == "wino"] \
        == [0, 9, 10, 11]


@pytest.mark.parametrize("size", ["reduced", "mid"])
def test_random_params_bitwise(size):
    img, scale = (32, 32) if size == "reduced" else (64, 4)
    r_specs = r_vgg.network_specs(img, scale, n_classes=10)
    t_specs = t_vgg.network_specs(img, scale, n_classes=10)
    r_params = r_api.random_params(r_specs, seed=3)
    t_params = t_api.random_params(t_specs, seed=3, device="cpu")
    assert len(r_params) == len(t_params) == 16
    for (rw, rb), (tw, tb) in zip(r_params, t_params):
        assert tw.dtype == torch.float32 and tw.device.type == "cpu"
        np.testing.assert_array_equal(tw.numpy(), np.asarray(rw))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(rb))
