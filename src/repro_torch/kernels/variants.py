"""Building and timing variants of a CUDA source, for the kernel breakdowns
(``flash_attention/breakdown.py``, ``gemm/breakdown.py``,
``winograd/breakdown.py``): each variant is
a source of ``csrc/`` with a few passages replaced, compiled beside the
committed one into its own shared library. Needs ``nvcc`` and a CUDA card.
"""
from __future__ import annotations

import statistics
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import common


def replace_passages(text: str, passages, what: str) -> str:
    """``text`` with each (passage, replacement) applied; a passage that is
    not in it exactly once raises, so the variants follow the source."""
    for passage, replacement in passages:
        if text.count(passage) != 1:
            raise RuntimeError(f"{what}: passage not found once:\n{passage}")
        text = text.replace(passage, replacement)
    return text


def compile_sources(sources: dict[str, str],
                    out_dir: Path) -> dict[str, tuple[Path | None, str]]:
    """Compile each (name -> CUDA source text) with ``nvcc`` into
    ``out_dir/<name>.so``, all in parallel, ``csrc/`` on the include path;
    return name -> (the library, or None where nvcc failed; its output)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, jobs = common._nvcc(), {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-I", str(common.CSRC_DIR), "-shared",
             str(cu), "-o", str(cu.with_suffix(".so"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    built = {}
    for name, (so, proc) in jobs.items():
        out, err = proc.communicate()
        built[name] = (so if proc.returncode == 0 else None, out + err)
    return built


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float | None:
    """Device time per call of the kernels ``fn`` launches, from
    ``torch.profiler`` (CUPTI) over ``reps`` calls after one: no host time
    in it, where ``time_ms`` holds the launch too for a kernel shorter than
    its host path. None where the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 if total else None
