"""The yardstick of the kernel metrics: the card's peaks and the least time
a kernel's work can take on it, frozen here so that a change to the program
cannot move it.

Sources. HBM_BYTES_PER_S: NVIDIA's H100 SXM data sheet (3.35 TB/s at the
700 W limit). SM_COUNT and SM_CLOCK_HZ: the card (132 SMs; nvidia-smi
clocks.max.sm 1,980 MHz). INT32_OPS_PER_S: 64 integer-ALU instructions a
clock an SM (int32 min/max, compare, logic, byte permute and the DPX
add-and-max, each one instruction), and F32_OPS_PER_S: 128 a clock, the
most an SM issues of any mix; both measured on the card by the repository's
``scripts/issue_rates.py`` (63.4-63.75 and 126-127). The counts of B4's
work follow ``chip_smoke.py``'s b4_bound and b4p_bound: 8 integer-ALU and 3
other operations a band cell of each row the pass needs.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SM_COUNT, SM_CLOCK_HZ = 132, 1.98e9
INT32_OPS_PER_S = SM_COUNT * 64 * SM_CLOCK_HZ
F32_OPS_PER_S = SM_COUNT * 128 * SM_CLOCK_HZ
#: a Bloom row's bytes are its 32-bit words; B4's operations a band cell
WORD_BYTES = 4
B4_ALU_CELL, B4_OTHER_CELL = 8, 3


def bound_s(nbytes: float, alu: float = 0.0, other: float = 0.0) -> float:
    """The least seconds: the larger of the bytes at HBM_BYTES_PER_S, the
    ALU operations at INT32_OPS_PER_S and all operations at F32_OPS_PER_S."""
    return max(nbytes / HBM_BYTES_PER_S, alu / INT32_OPS_PER_S, (alu + other) / F32_OPS_PER_S)


def gather_bound_s(distinct_rows: int, words_per_row: int) -> float:
    """A match call reads each distinct Bloom row its queries name at least
    once: distinct_rows x words_per_row x 4 bytes at HBM_BYTES_PER_S."""
    return bound_s(distinct_rows * words_per_row * WORD_BYTES)


def b4_bound_s(rows: int, p: int, l: int, band: int, plane: bool, packed: bool) -> float:
    """One launch of B4 over p pairs of l query rows and a band: ``rows``
    is the rows the pass needs (the sum of the query lengths, or p * l with
    the plane). Operations: B4_ALU_CELL and B4_OTHER_CELL a band cell of
    those rows. Bytes, each read or written once: the query and window
    codes (2-bit packed in the packed instance, with [lo, hi) bounds; else
    a byte a code and a byte of mask a window column), the lengths, score
    and end diagonal, and the plane."""
    cells = rows * band
    if packed:
        nbytes = p * (-(-l // 4) + 4 + -(-(l + band) // 4) + 8 + 8)
    else:
        nbytes = p * l + 4 * p + 2 * p * (l + band) + 8 * p
    if plane:
        nbytes += 4 * p * l * band
    return bound_s(nbytes, cells * B4_ALU_CELL, cells * B4_OTHER_CELL)
