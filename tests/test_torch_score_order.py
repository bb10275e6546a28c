"""The premise of the fused head's ordered path (``csrc/ordered_select.cuh``):
the greedy step loop (``ops/nms_pallas.greedy_select_loop``: take the best
candidate left, the lower index on a tie, suppress what it overlaps) gives
the same winners as one visit of each row's candidates at or above the
threshold in the order (score descending, index ascending), keeping each
one that no winner kept before it suppresses, up to max_out.

The scan is written here, apart from the port's code, with the loop's own
IoU test (the candidate's box and area against the winner's box floored at
-1e9).  At a threshold at or below -1e9 a suppressed candidate (score
-1e9) stays selectable in the loop and the two differ: the head keeps the
step loop there.
"""

import numpy as np
import pytest
import torch

from k210_yolo_framework_tpu_torch.ops.nms_pallas import greedy_select_loop

NEG = -1e9
IOU = 0.45


def _suppressed(c, w):
    """Whether winner box(es) ``w`` (y0, x0, y1, x1, each [k], floored)
    suppress candidate ``c`` (y0, x0, y1, x1, each 0-d): the loop's float32
    arithmetic, op for op."""
    zero = torch.zeros((), dtype=torch.float32)
    cy0, cx0, cy1, cx1 = c
    wy0, wx0, wy1, wx1 = w
    area = torch.maximum(cy1 - cy0, zero) * torch.maximum(cx1 - cx0, zero)
    w_area = torch.maximum(wy1 - wy0, zero) * torch.maximum(wx1 - wx0, zero)
    iy = torch.maximum(torch.minimum(wy1, cy1) - torch.maximum(wy0, cy0), zero)
    ix = torch.maximum(torch.minimum(wx1, cx1) - torch.maximum(wx0, cx0), zero)
    inter = iy * ix
    union = w_area + area - inter
    iou = torch.where(union > 0, inter / union, zero)
    return bool((iou > IOU).any())


def score_order_scan(scores, y0, x0, y1, x1, max_out, stop_below):
    """scores and boxes [R, N] -> the loop's five [R, max_out] buffers,
    by one visit of each row in score order."""
    rows, n = scores.shape
    out = [torch.full((rows, max_out), NEG)] + [
        torch.zeros((rows, max_out)) for _ in range(4)]
    for r in range(rows):
        s = scores[r]
        if s.isnan().any():
            continue
        live = [j for j in range(n) if float(s[j]) >= stop_below]
        # -0.0 == 0.0 here: zeros of either sign tie, the lower index first
        live.sort(key=lambda j: (-float(s[j]), j))
        kept = []
        for j in live:
            if len(kept) == max_out:
                break
            box = (y0[r, j], x0[r, j], y1[r, j], x1[r, j])
            if kept and _suppressed(box, [torch.stack(
                    [w[i] for w in kept]) for i in range(4)]):
                continue
            floored = tuple(torch.maximum(v, torch.tensor(NEG)) for v in box)
            out[0][r, len(kept)] = s[j]
            for i in range(4):
                out[i + 1][r, len(kept)] = floored[i]
            kept.append(floored)
    return out


def _rows(case, rng):
    """(scores, boxes y0, x0, y1, x1 [R, N], max_out, threshold)."""
    rows, n = 6, 240
    cy, cx = rng.uniform(0, 100, (2, rows, n))
    h, w = rng.uniform(2, 30, (2, rows, n))
    scores = rng.uniform(0, 1, (rows, n))
    max_out, thresh = 30, 0.3
    if case == "tied":
        scores = rng.integers(0, 4, (rows, n)) / 4.0
        scores[:, ::3] *= -1.0          # -0.0 beside +0.0
        max_out, thresh = 200, 0.0
    elif case == "clustered":
        centre = rng.uniform(0, 100, (2, rows, 5))
        pick = rng.integers(0, 5, (rows, n))
        cy = np.take_along_axis(centre[0], pick, 1) + rng.normal(0, 1.5,
                                                                 (rows, n))
        cx = np.take_along_axis(centre[1], pick, 1) + rng.normal(0, 1.5,
                                                                 (rows, n))
        h = w = np.full((rows, n), 12.0)
        max_out, thresh = 10, 0.05
    elif case == "nan":
        scores[1, 17] = np.nan          # one NaN: the row selects none
        scores[3, 200] = np.nan
        cy[2, ::9] = np.nan             # NaN boxes are never suppressed
        w[4, ::11] = np.inf
    elif case == "long":
        max_out, thresh = 500, 0.6      # fewer live than max_out
    elif case == "below_floor":
        cx[:, ::2] = rng.uniform(-5e9, -1e9, (rows, n // 2))
        w[:, ::4] = rng.uniform(1e9, 9e9, (rows, n // 4))
    elif case == "keep_all":
        # ten overlapping boxes score 0.5, the rest -3e9: the loop selects
        # the suppressed nine again at -1e9, the scan never
        scores[:] = -3e9
        scores[:, :10] = 0.5
        cy[:, :10], cx[:, :10], h[:, :10], w[:, :10] = 50.0, 50.0, 20.0, 20.0
        cy[:, :10] += np.arange(10) * 0.1
        max_out, thresh = 30, -2e9
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f(scores), f(cy - h / 2), f(cx - w / 2), f(cy + h / 2),
            f(cx + w / 2), max_out, thresh)


CASES = ["random", "tied", "clustered", "nan", "long", "below_floor",
         "keep_all"]


@pytest.mark.parametrize("case", CASES)
def test_score_order_scan_equals_the_step_loop(case):
    """Rows that are random, tied (+0 and -0 among them), clustered, hold
    a NaN, have fewer live candidates than max_out, or corners below the
    winner's -1e9 floor: the scan's buffers are the loop's, bit for bit.
    At a threshold of -2e9 (``keep_all``) they are not."""
    scores, y0, x0, y1, x1, max_out, thresh = _rows(
        case, np.random.default_rng(CASES.index(case)))
    loop = greedy_select_loop(scores, y0, x0, y1, x1, max_out, IOU,
                              stop_below=thresh)
    scan = score_order_scan(scores, y0, x0, y1, x1, max_out, thresh)
    kept = (loop[0] >= thresh).sum(-1)
    if case == "keep_all":
        # the loop's slots 1-9 hold suppressed boxes at -1e9; the scan's
        # are empty
        assert bool((loop[0][:, 1:10] == NEG).all())
        assert bool((loop[1][:, 1:10] != 0).all())
        assert bool((scan[1][:, 1:] == 0).all())
        assert not torch.equal(loop[1], scan[1])
        return
    # a row whose best is below the threshold stops; the plain loop runs on
    # while another row goes on, into slots its callers mask (as here)
    valid = loop[0] >= thresh
    loop = [torch.where(valid, loop[0], torch.tensor(NEG))] + [
        torch.where(valid, b, torch.tensor(0.0)) for b in loop[1:]]
    for a, b in zip(loop, scan):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    if case == "nan":
        assert not kept[1] and not kept[3] and kept[[0, 2, 4, 5]].all()
    elif case == "tied":
        assert bool((loop[0] == 0).any())       # zeros selected in order
    elif case == "long":
        assert 0 < int(kept.max()) < max_out
    else:
        assert bool(kept.all())
