"""The 128-bit customized instruction set (Sec. 4.1, Figure 2), full-network.

Nine opcodes — LOAD_INP, LOAD_WGT, LOAD_BIAS, COMP, SAVE, POOL, FC,
ELTWISE_ADD, DEPTHWISE_CONV — each encoded in 128 bits (four little-endian
uint32 words). Every instruction carries a WINO_FLAG indicating the current
CONV mode; LOAD/SAVE instructions carry BUFF_BASE / DRAM_BASE so the compiler
fully controls data movement and can realize IS or WS dataflow purely in the
instruction stream (Sec. 4.2.4). POOL and FC extend the CONV ISA so a whole
model — CONVs, interleaved maxpools, and the FC classifier tail — compiles
into ONE instruction stream (one ``Program``), with no host-side glue between
layers. ELTWISE_ADD and DEPTHWISE_CONV extend it beyond straight-line VGG
chains: residual (skip-connection) adds with TWO DRAM source operands kept
live by the compiler's planner, and depthwise convolutions.

Bit layout (word:bit, little-endian within the 128-bit word):

  word0: [ 3:0]  OPCODE        [4] WINO_FLAG      [5] DATAFLOW (0=IS,1=WS)
         [6]    LAYOUT_OUT (SAVE: 0=SPAT,1=WINO)  [7] RELU_FLAG
         [15:8] M_TILE (Winograd m) — POOL reuses this byte as
                [11:8] POOL_WINDOW, [15:12] POOL_STRIDE
         [31:16] LAYER_ID
  word1: BUFF_BASE  (32b on-chip buffer word address / ping-pong slot;
                     ELTWISE_ADD: [0] primary slot, [1] skip slot)
  word2: DRAM_BASE  (32b external-memory word address; ELTWISE_ADD: the
                     skip operand's DRAM base — the second source is named
                     in the compute word so the two-source read is explicit
                     in the stream, not implied by load order)
  word3: SIZE       (32b transfer size in words; COMP: group index;
                     FC: [15:0] D_IN, [31:16] D_OUT — see pack_fc_dims;
                     ELTWISE_ADD: element count of each source operand;
                     DEPTHWISE_CONV: [7:0] R, [15:8] S, [23:16] STRIDE —
                     see pack_dw_geom)

The two LOAD_INPs feeding an ELTWISE_ADD use the ordinary ping-pong slot
tags: the primary operand loads into slot 0 (buff_base bit0 = 0) and the
skip operand into slot 1 (buff_base bit0 = 1), so the hazard discipline that
guards CONV row groups guards residual adds unchanged.

Opcode values 0 and 10..15 are reserved: ``decode`` rejects them with a
``ValueError`` naming the offending word. The encode/decode pair is
bit-exact and round-trip tested (hypothesis).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class Opcode(enum.IntEnum):
    LOAD_INP = 1
    LOAD_WGT = 2
    LOAD_BIAS = 3
    COMP = 4
    SAVE = 5
    POOL = 6
    FC = 7
    ELTWISE_ADD = 8
    DEPTHWISE_CONV = 9


def pack_fc_dims(d_in: int, d_out: int) -> int:
    """FC word3: [15:0] input dim, [31:16] output dim."""
    if not (0 <= d_in < 1 << 16 and 0 <= d_out < 1 << 16):
        raise ValueError(f"FC dims ({d_in}, {d_out}) exceed 16 bits")
    return d_in | (d_out << 16)


def unpack_fc_dims(size: int) -> tuple[int, int]:
    return size & 0xFFFF, (size >> 16) & 0xFFFF


def pack_dw_geom(r: int, s: int, stride: int) -> int:
    """DEPTHWISE_CONV word3: [7:0] R, [15:8] S, [23:16] STRIDE."""
    if not (0 < r < 1 << 8 and 0 < s < 1 << 8 and 0 < stride < 1 << 8):
        raise ValueError(
            f"depthwise geometry ({r}, {s}, stride={stride}) must be "
            f"positive 8-bit values")
    return r | (s << 8) | (stride << 16)


def unpack_dw_geom(size: int) -> tuple[int, int, int]:
    return size & 0xFF, (size >> 8) & 0xFF, (size >> 16) & 0xFF


@dataclasses.dataclass(frozen=True)
class Instruction:
    opcode: Opcode
    wino_flag: bool = False          # current CONV mode
    dataflow_ws: bool = False        # 0 = IS, 1 = WS
    layout_out_wino: bool = False    # SAVE: layout written for the next layer
    relu_flag: bool = False
    m_tile: int = 0                  # Winograd output tile size m (0 for SPAT)
    pool_window: int = 0             # POOL only: window (word0 [11:8])
    pool_stride: int = 0             # POOL only: stride (word0 [15:12])
    layer_id: int = 0
    buff_base: int = 0
    dram_base: int = 0
    size: int = 0

    def encode(self) -> np.ndarray:
        """-> uint32[4] (128 bits)."""
        if not (0 <= self.layer_id < 1 << 16):
            raise ValueError("layer_id out of range")
        if self.opcode == Opcode.POOL:
            # POOL reuses the M_TILE byte for window/stride
            if self.m_tile:
                raise ValueError("POOL carries window/stride, not m_tile")
            if not (0 <= self.pool_window < 1 << 4):
                raise ValueError("pool_window out of range (4 bits)")
            if not (0 <= self.pool_stride < 1 << 4):
                raise ValueError("pool_stride out of range (4 bits)")
            byte = self.pool_window | (self.pool_stride << 4)
        else:
            if self.pool_window or self.pool_stride:
                raise ValueError(
                    f"pool window/stride only valid on POOL, not {self.opcode.name}")
            if not (0 <= self.m_tile < 1 << 8):
                raise ValueError("m_tile out of range")
            byte = self.m_tile
        w0 = (int(self.opcode) & 0xF)
        w0 |= (1 << 4) if self.wino_flag else 0
        w0 |= (1 << 5) if self.dataflow_ws else 0
        w0 |= (1 << 6) if self.layout_out_wino else 0
        w0 |= (1 << 7) if self.relu_flag else 0
        w0 |= (byte & 0xFF) << 8
        w0 |= (self.layer_id & 0xFFFF) << 16
        words = [w0, self.buff_base & 0xFFFFFFFF,
                 self.dram_base & 0xFFFFFFFF, self.size & 0xFFFFFFFF]
        return np.array(words, dtype=np.uint32)


def decode(words: np.ndarray) -> Instruction:
    """uint32[4] -> Instruction.

    Raises ``ValueError`` naming the offending word for reserved /
    out-of-range opcode values (0, 10..15) rather than surfacing the bare
    enum error.
    """
    w0, buff, dram, size = (int(w) for w in np.asarray(words, np.uint32))
    code = w0 & 0xF
    try:
        opcode = Opcode(code)
    except ValueError:
        raise ValueError(
            f"reserved/out-of-range opcode {code} in instruction "
            f"word0=0x{w0:08x} (valid: "
            f"{', '.join(f'{o.name}={int(o)}' for o in Opcode)})") from None
    byte = w0 >> 8 & 0xFF
    is_pool = opcode == Opcode.POOL
    return Instruction(
        opcode=opcode,
        wino_flag=bool(w0 >> 4 & 1),
        dataflow_ws=bool(w0 >> 5 & 1),
        layout_out_wino=bool(w0 >> 6 & 1),
        relu_flag=bool(w0 >> 7 & 1),
        m_tile=0 if is_pool else byte,
        pool_window=byte & 0xF if is_pool else 0,
        pool_stride=byte >> 4 & 0xF if is_pool else 0,
        layer_id=w0 >> 16 & 0xFFFF,
        buff_base=buff,
        dram_base=dram,
        size=size,
    )


def encode_stream(instrs: list[Instruction]) -> np.ndarray:
    """-> uint32[n, 4] instruction memory image."""
    if not instrs:
        return np.zeros((0, 4), np.uint32)
    return np.stack([i.encode() for i in instrs])


def decode_stream(image: np.ndarray) -> list[Instruction]:
    return [decode(row) for row in np.asarray(image, np.uint32).reshape(-1, 4)]
