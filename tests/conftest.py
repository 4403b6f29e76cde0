import numpy as np
import pytest


def pytest_configure(config):
    # Registered here as well as in pytest.ini so bare `python -m pytest
    # tests/...` invocations from another rootdir still know the tiers.
    config.addinivalue_line(
        "markers", "slow: heavy integration / per-architecture cases "
        "(full tier; excluded by default)")
    config.addinivalue_line(
        "markers", "multidevice: needs >1 device via a subprocess with "
        "forced host devices (excluded by default)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card and nvcc (skips without them)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def flip_first_comp(program, layer_id: int = 0):
    """Invert exactly one COMP block's RELU bit -> a non-uniform stream
    that the lowering optimizer must NOT fuse. Shared by the opt-lowering
    unit tests and the hypothesis property suite so the stream-rewriting
    logic cannot drift between them."""
    import dataclasses

    from repro.core.isa import Opcode

    out, done = [], False
    for ins in program.instructions:
        if (not done and ins.opcode == Opcode.COMP
                and ins.layer_id == layer_id):
            out.append(dataclasses.replace(ins, relu_flag=not ins.relu_flag))
            done = True
        else:
            out.append(ins)
    assert done, f"no COMP instruction for layer {layer_id}"
    return type(program)(out, program.layers, program.dram_size_words)
