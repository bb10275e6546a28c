"""Faults planted in the program underneath a run, to show the check catches
them (``tests/test_yb_faults.py`` on the CPU; ``readings --fault`` on the
chip).  Each patches a function of the program in this process and
returns an undo callable:

* ``half_batch`` (training): the preprocess hands the step only the first
  half of the batch, so the loss is the mean over the rest;
* ``state_unchanged`` (training): the step returns its state untouched;
* ``answers_altered`` (serving): every detection's class is shifted by one
  where the Predictor produces it;
* ``half_answers`` (serving): the detections of the second half of a
  batch are left out.
"""

from __future__ import annotations

from typing import Callable


def _patch(owner, name: str, make) -> Callable[[], None]:
    old = getattr(owner, name)
    setattr(owner, name, make(old))
    return lambda: setattr(owner, name, old)


def half_batch() -> Callable[[], None]:
    from k210_yolo_framework_tpu_torch.data import pipeline as PL

    def make(old):
        def make_preprocess_fn(*args, **kwargs):
            pp = old(*args, **kwargs)

            def half(*a, **k):
                imgs, labels = pp(*a, **k)
                n = imgs.shape[0] // 2
                return imgs[:n], tuple(t[:n] for t in labels)
            return half
        return make_preprocess_fn
    return _patch(PL, "make_preprocess_fn", make)


def state_unchanged() -> Callable[[], None]:
    from k210_yolo_framework_tpu_torch.training import train as TT

    def make(old):
        def make_fused_train_step(*args, **kwargs):
            step = old(*args, **kwargs)

            def frozen(state, *a, **k):
                saved = {n: p.detach().clone()
                         for n, p in state.net.named_parameters()}
                moments = {id(p): {k2: v.clone() for k2, v in s.items()}
                           for p, s in state.optimizer.state.items()}
                state, logs = step(state, *a, **k)
                for n, p in state.net.named_parameters():
                    p.data.copy_(saved[n])
                for p, s in state.optimizer.state.items():
                    if id(p) in moments:
                        s.update(moments[id(p)])
                    else:
                        for v in s.values():
                            if hasattr(v, "zero_"):
                                v.zero_()
                return state, logs
            return frozen
        return make_fused_train_step
    return _patch(TT, "make_fused_train_step", make)


def answers_altered() -> Callable[[], None]:
    from k210_yolo_framework_tpu_torch import inference as INF

    def make(old):
        def _detections(res, b):
            d = old(res, b)
            classes = int(res.classes.max()) + 1
            return INF.Detections(d.boxes, d.scores,
                                  (d.classes + 1) % classes)
        return _detections
    return _patch(INF, "_detections", make)


def half_answers() -> Callable[[], None]:
    from k210_yolo_framework_tpu_torch import inference as INF

    def make(old):
        def _detections(res, b):
            d = old(res, b)
            if b >= res.scores.shape[0] // 2:
                return INF.Detections(d.boxes[:0], d.scores[:0],
                                      d.classes[:0])
            return d
        return _detections
    return _patch(INF, "_detections", make)


FAULTS = {"half_batch": half_batch, "state_unchanged": state_unchanged,
          "answers_altered": answers_altered, "half_answers": half_answers}
# the faults a cell can have, by the entry kind that drives it
FOR_ENTRY = {"train_step": ("half_batch", "state_unchanged"),
             "serve_batch": ("answers_altered", "half_answers")}
