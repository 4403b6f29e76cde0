"""VGG16 — the paper's case-study model (Sec. 6.1): the spec builders.

13 CONV layers, 5 maxpools and 3 FC layers as one compilable spec chain,
identical to the reference package's ``models/vgg.py`` so both packages run
the same DSE and compile the same ``Program``.
"""
from __future__ import annotations

from repro_torch.core.hybrid_conv import ConvSpec, FCSpec, PoolSpec

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
