"""The edge cases of the ragged ``strings`` gather
(:func:`.strings.gather_strings`), built with numpy from a seed: one
generator for the card tests (``tests/test_torch_cuda.py``), the CPU
tests against the JAX package and ``chip_smoke.py``, so a case changed
here reaches all three.
"""

from __future__ import annotations

import numpy as np

GATHER_CASES = ["mixed", "all valid", "none valid", "indices out of range",
                "negative lengths", "wrapped lengths", "one source row",
                "empty rows", "runs to the last byte"]
GATHER_WIDTHS = [8, 128]
#: Output rows on the card: one 1,024-row tile and either side of it, and
#: several tiles, so the look-back runs.
GATHER_CARD_ROWS = [1, 255, 256, 257, 1023, 1024, 1025, 8192, 100_003,
                    262_144]
INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def gather_strings_case(name: str, m: int, w: int, seed: int = 0):
    """(payload uint8, offsets int32 [n + 1], idx int32 [m], valid bool
    [m]) of one ragged ``strings`` gather case: source lengths 0-5, W,
    past W and random, entries starting at odd payload bytes, rows about
    80 % valid. Variants: every or no row valid; indices below 0 and at
    or past n; offsets that step back (negative lengths); int32 offsets
    whose difference wraps (INT32_MAX - 1 to INT32_MIN: 0 bytes; INT32_MIN
    to a real end: W bytes, all of them clamped to payload byte 0); one
    source row; all sources empty; a payload that ends at the last
    entry's last byte."""
    rng = np.random.default_rng(seed + 7 * m + w + len(name))
    n = 1 if name == "one source row" else max(m // 2, 1) + 3
    lens = rng.integers(0, w + 1, n)
    pick = rng.random(n)
    lens[pick < 0.3] = rng.integers(0, 6, int((pick < 0.3).sum()))
    lens[(pick >= 0.3) & (pick < 0.4)] = w
    past = (pick >= 0.4) & (pick < 0.5)
    lens[past] = w + rng.integers(1, 10, int(past.sum()))
    if name == "empty rows":
        lens[:] = 0
    offsets = 3 + np.concatenate([[0], np.cumsum(lens)])
    if name == "negative lengths":
        back = np.flatnonzero(rng.random(n) < 0.2) + 1
        offsets[back] = np.maximum(offsets[back - 1] - rng.integers(
            1, 4, len(back)), 0)
    slack = 0 if name == "runs to the last byte" else 5
    payload = rng.integers(0, 256, int(offsets.max()) + slack
                           ).astype(np.uint8)
    if name == "wrapped lengths":
        for k in range(1, n - 1, 7):
            offsets[k], offsets[k + 1] = INT32_MAX - 1, INT32_MIN
    idx = rng.integers(0, n, m)
    if name == "indices out of range":
        idx = rng.integers(-50, n + 50, m)
        idx[:2] = np.array([-1, n])[:m]
    valid = rng.random(m) < 0.8
    if name == "all valid":
        valid[:] = True
    elif name == "none valid":
        valid[:] = False
    return (payload, offsets.astype(np.int32), idx.astype(np.int32),
            valid)
