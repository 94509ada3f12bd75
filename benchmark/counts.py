"""Operations and bytes of the measured work, computed from shapes, and the
card's peaks they are held against.

The search's count is a copy of the port's ``chip_smoke.py _bound_ms``
(9 fp32 operations a pair: three differences, three absolute values, two
adds and the compare; inputs read once, each point's nearest distance and
index written once).  Pairs are counted over the valid (unmasked) points.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

OPS_PER_PAIR = 9
# a search's outputs a point: a float32 distance and an int64 index
SEARCH_OUT_BYTES = 4 + 8


def search_ops(pairs: int) -> float:
    """Operations of one bidirectional search over ``pairs`` point pairs."""
    return float(pairs) * OPS_PER_PAIR


def search_bytes(points: int) -> float:
    """Bytes of one bidirectional search over ``points`` points of both
    clouds: the coordinates read once, one distance and index written once."""
    return float(points) * (3 * 4 + SEARCH_OUT_BYTES)


def bound_seconds(ops: float, nbytes: float) -> float:
    """Least time for work of ``ops`` fp32 operations and ``nbytes`` bytes:
    the larger of the two at the card's peaks."""
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def mlp_forward_flops(layers: list[tuple[int, int]], rows: int) -> float:
    """Multiply-adds of dense layers ``(in, out)`` on ``rows`` rows, two
    operations each, plus the bias adds."""
    return float(rows) * sum(2 * i * o + o for i, o in layers)


def pose_mlp_layers(mode: str, hidden: int) -> list[tuple[int, int]]:
    """The dense layers of the registration's pose MLP (mode ``q``: input
    ``[xyz, quat]`` with a 4-octave sin/cos encoding, a shared encoder, an
    xyz head and a rotation head)."""
    if mode != "q":
        raise ValueError(f"only mode 'q' is counted, not {mode!r}")
    enc = 8 * 7
    return [(enc, hidden), (hidden, hidden // 2), (hidden // 2, 3),
            (hidden, hidden), (hidden, 4)]


# A point's rigid transform, forward: 9 products and 9 adds.
TRANSFORM_FLOPS = 18


def epoch_flops(seq_pairs: int, seq_points: int, sequences: int, clusters: int,
                mode: str, hidden: int) -> float:
    """Operations of one registration epoch of a sequence batch: the search
    over ``seq_pairs`` valid pairs, the pose MLP on ``clusters`` rows a
    sequence forward and backward (twice the forward), and the
    ``seq_points`` source points' transforms forward and backward."""
    mlp = mlp_forward_flops(pose_mlp_layers(mode, hidden), clusters) * sequences * 3
    return search_ops(seq_pairs) + mlp + 3.0 * TRANSFORM_FLOPS * seq_points
