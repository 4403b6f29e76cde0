"""A residual add in plain PyTorch: the map the entry reads plus the map
its ``skip`` names."""


def weight_shape(layer: dict):
    return None


def forward(layer: dict, x, params, skip, cast):
    if skip is None:
        raise ValueError(f"{layer['name']}: an add names its 'skip'")
    return x + skip
