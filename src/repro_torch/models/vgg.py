"""VGG16 — the paper's case-study model (Sec. 6.1), on the hybrid engine.

13 CONV layers, 5 maxpools and 3 FC layers as one compilable spec chain,
identical to the reference package's ``models/vgg.py`` so both packages run
the same DSE and compile the same ``Program``. ``accelerator`` is the
one-call build; ``init_params`` / ``forward`` are the raw per-layer path
(``hybrid_conv2d``, ``max_pool2d``, ``dense``) outside the compiled
program, and ``params_from_numpy`` carries the reference's raw param tree
into it.
"""
from __future__ import annotations

import torch

from repro_torch.compat import resolve_device, to_tensor
from repro_torch.core.compiler import LayerPlan
from repro_torch.core.hybrid_conv import (
    ConvSpec,
    FCSpec,
    PoolSpec,
    dense,
    hybrid_conv2d,
    max_pool2d,
)
from repro_torch.models.layers import _init

# (input hw, in_ch, out_ch); 'M' = 2x2 maxpool
_VGG16 = [
    (224, 3, 64), (224, 64, 64), "M",
    (112, 64, 128), (112, 128, 128), "M",
    (56, 128, 256), (56, 256, 256), (56, 256, 256), "M",
    (28, 256, 512), (28, 512, 512), (28, 512, 512), "M",
    (14, 512, 512), (14, 512, 512), (14, 512, 512), "M",
]


def conv_specs(img: int = 224, scale: int = 1) -> list[ConvSpec]:
    """The 13 CONV ConvSpecs. ``scale`` divides channel counts (smoke tests);
    ``img`` rescales the input resolution."""
    specs = []
    i = 0
    for entry in _VGG16:
        if entry == "M":
            continue
        h, c, k = entry
        hh = h * img // 224
        specs.append(ConvSpec(
            f"conv{i}", hh, hh, max(3, c // scale) if c == 3 else c // scale,
            k // scale, relu=True))
        i += 1
    return specs


def network_specs(img: int = 224, scale: int = 1, *, n_classes: int = 1000,
                  fc_dim: int | None = None
                  ) -> list[ConvSpec | PoolSpec | FCSpec]:
    """The FULL 21-layer VGG16 as one compilable spec chain: 13 CONVs with
    the 5 interleaved 2x2 maxpools and the 3-layer FC classifier tail.
    ``scale`` divides channel/FC widths (smoke tests); ``img`` rescales the
    input resolution (must be divisible by 32)."""
    convs = conv_specs(img, scale)
    specs: list = []
    ci, hw, c, pi = 0, img, 0, 0
    for entry in _VGG16:
        if entry == "M":
            specs.append(PoolSpec(f"pool{pi}", hw, hw, c))
            hw //= 2
            pi += 1
        else:
            s = convs[ci]
            specs.append(s)
            ci, hw, c = ci + 1, s.h, s.k
    feat = hw * hw * c
    fc_dim = fc_dim or max(64, 4096 // scale)
    specs += [FCSpec("fc1", feat, fc_dim, relu=True),
              FCSpec("fc2", fc_dim, fc_dim, relu=True),
              FCSpec("fc3", fc_dim, n_classes, relu=False)]
    return specs


def conv_segments() -> list[int]:
    """Consecutive-CONV run lengths between maxpools: [2, 2, 3, 3, 3] —
    the legacy multi-Program path's segments (``Accelerator.build(...,
    segmented=True)``: one Program per segment, a host maxpool between
    them, the FC tail outside the runtime)."""
    sizes, run = [], 0
    for entry in _VGG16:
        if entry == "M":
            if run:
                sizes.append(run)
            run = 0
        else:
            run += 1
    if run:
        sizes.append(run)
    return sizes


def default_plans(specs: list[ConvSpec] | None = None, *,
                  target=None, batch: int = 1) -> list[LayerPlan]:
    """DSE-selected plans through the ``Target`` protocol; defaults to the
    TPU planning model ``pm.V5E`` (the reference's, so both packages plan
    the same layers)."""
    from repro_torch.core import perf_model as pm
    specs = specs or conv_specs()
    target = target if target is not None else pm.V5E
    return target.run_dse(specs, batch=batch).plans


def accelerator(*, img: int = 224, scale: int = 1, n_classes: int = 1000,
                target=None, batch: int = 8, seed: int = 0,
                backend: str = "torch", opt_level: int = 1, device=None,
                **kwargs):
    """One-call VGG16 accelerator: ``network_specs`` ->
    ``api.Accelerator.build`` with the executor knobs surfaced —
    ``backend`` (PE implementation), ``opt_level`` (lowering optimizer;
    0 = literal per-block reference) and ``device`` (``None`` = the CUDA
    card). Extra keywords pass straight to ``Accelerator.build``."""
    from repro_torch import api
    from repro_torch.core import perf_model as pm
    specs = network_specs(img=img, scale=scale, n_classes=n_classes)
    return api.Accelerator.build(
        specs, target if target is not None else pm.V5E, batch=batch,
        seed=seed, backend=backend, opt_level=opt_level, device=device,
        **kwargs)


def init_params(generator: torch.Generator, cfg=None, *, img: int = 224,
                scale: int = 1, n_classes: int = 1000, device=None,
                dtype=torch.float32) -> dict:
    """Raw VGG16 param tree for :func:`forward` (not the compiled path),
    drawn from ``generator`` on ``device`` (``None``: the CUDA card; the
    generator must live there). The reference draws from the JAX PRNG,
    which torch cannot reproduce: carry its tree across with
    :func:`params_from_numpy` for parity.

    ``cfg`` carries no VGG sizing information, so a non-None value would be
    silently ignored; it raises instead, as in the reference.
    """
    if cfg is not None:
        raise ValueError(
            "vgg.init_params does not derive shapes from a ModelConfig — "
            "pass img=/scale=/n_classes= explicitly (cfg would be "
            "silently ignored)")
    device = resolve_device(device)
    specs = conv_specs(img, scale)
    convs = []
    for s in specs:
        w = _init(generator, (s.r, s.s, s.c, s.k),
                  scale=(s.r * s.s * s.c) ** -0.5, dtype=dtype,
                  device=device)
        convs.append({"w": w, "b": torch.zeros((s.k,), dtype=dtype,
                                               device=device)})
    feat = (img // 32) ** 2 * specs[-1].k
    fc_dim = max(64, 4096 // scale)
    tree = {"convs": convs}
    for name, shape in (("fc1", (feat, fc_dim)), ("fc2", (fc_dim, fc_dim)),
                        ("fc3", (fc_dim, n_classes))):
        tree[name] = {"w": _init(generator, shape, dtype=dtype,
                                 device=device),
                      "b": torch.zeros((shape[1],), dtype=dtype,
                                       device=device)}
    return tree


def params_from_numpy(tree: dict, device) -> dict:
    """The reference's raw param tree (``vgg.init_params``, as numpy or JAX
    arrays) -> the same tree of float32 tensors on ``device``."""
    device = torch.device(device)
    return {k: ([{n: to_tensor(a, device) for n, a in c.items()} for c in v]
                if k == "convs"
                else {n: to_tensor(a, device) for n, a in v.items()})
            for k, v in tree.items()}


def forward(params: dict, x_nhwc: torch.Tensor, plans: list[LayerPlan], *,
            backend: str = "torch") -> torch.Tensor:
    """x: (N, img, img, C0) -> logits (N, n_classes), layer by layer:
    ``hybrid_conv2d`` in each CONV plan's mode/dataflow/m, ``max_pool2d``,
    ``dense``. ``backend`` selects the PE ("torch": aten ops, which take
    only ``"is"`` plans, as the reference's XLA path; "hopper": the
    kernels)."""
    x = x_nhwc
    ci = 0
    with torch.no_grad():
        for entry in _VGG16:
            if entry == "M":
                x = max_pool2d(x)
                continue
            p, plan = params["convs"][ci], plans[ci]
            x = hybrid_conv2d(
                x, p["w"], p["b"], mode=plan.mode, m=plan.m,
                dataflow=plan.dataflow, relu=True, backend=backend)
            ci += 1
        x = x.reshape(x.shape[0], -1)
        x = dense(x, params["fc1"]["w"], params["fc1"]["b"], relu=True,
                  backend=backend)
        x = dense(x, params["fc2"]["w"], params["fc2"]["b"], relu=True,
                  backend=backend)
        return dense(x, params["fc3"]["w"], params["fc3"]["b"],
                     backend=backend)
