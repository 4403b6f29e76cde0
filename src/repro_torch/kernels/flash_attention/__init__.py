"""Blocked online-softmax attention (K6), hand-written for Hopper.

Off the CNN path: it carries the prefill attention of the LM side
(``models/layers.py``, sequences of 2048 tokens and more).
"""
from repro_torch.kernels.flash_attention.ops import flash_attention

__all__ = ["flash_attention"]
