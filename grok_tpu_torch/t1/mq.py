"""MQ arithmetic coder tables (ISO/IEC 15444-1 Annex C).

The port's copy of the table half of grok_tpu/t1/mq.py: the 47-state
probability table, the Tier-1 context numbering and the initial context
states.  The coders themselves are the port's kernels (ops/t1_encode.py,
ops/t1_decode.py); the scalar MQEncoder/MQDecoder classes are not
copied.
"""

from __future__ import annotations

import numpy as np

# 47-state probability table: (Qe, NMPS, NLPS, SWITCH)  [ISO 15444-1 Table C.2]
MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

MQ_QE = np.array([row[0] for row in MQ_TABLE], dtype=np.uint32)
MQ_NMPS = np.array([row[1] for row in MQ_TABLE], dtype=np.uint8)
MQ_NLPS = np.array([row[2] for row in MQ_TABLE], dtype=np.uint8)
MQ_SWITCH = np.array([row[3] for row in MQ_TABLE], dtype=np.uint8)

# T1 context numbering (matches the conventional EBCOT layout):
#   0..8   zero coding
#   9..13  sign coding
#   14..16 magnitude refinement
#   17     run-length (aggregation)
#   18     uniform
N_CTX = 19
CTX_ZC = 0
CTX_SC = 9
CTX_MAG = 14
CTX_RL = 17
CTX_UNI = 18


def initial_ctx_states() -> list[list[int]]:
    """Initial (state_index, mps) per context [ISO 15444-1 D.2, Table D.7]."""
    states = [[0, 0] for _ in range(N_CTX)]
    states[CTX_UNI][0] = 46
    states[CTX_RL][0] = 3
    states[CTX_ZC][0] = 4
    return states
