"""Where a stream's decoded PCM depends on the batch it shares: the same
streams through one of the port's stream decoders as one batch of S and
as smaller batches, each stage of the step compared row for row. Shared
by the port's tests, chip_smoke.py and tools/torch_batch_invariance.py;
like golden_streams.py it is not part of any installed package.

A stage is a function of the port's step that `record_stages` wraps
while it is open: the band plans' X plane, the concealment's pitch, its
row work (the LPC and the extension of plc_rows, the kernel's outputs on
the card; on the CPU also the LPC fit, excitation and LPC synthesis of
its plain version) and re-entry spectrum, the IMDCT, the comb filter, the
PCM, and on the mixed path the SILK resamplers and the device-SILK
synthesis. The first stage that differs in the first frame
that differs is where the batch enters the step.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

from mousiki_tpu_torch import pipeline
from mousiki_tpu_torch.ops import band_exec, plc, synthesis


def _first(out):
    return out[0]


def _lpc_and_ext(out):
    """plc_rows' (lpc, ext), a row's LPC and extension side by side."""
    return torch.cat(out, dim=-1)


# (name, module, attribute, the output to keep): the modules' own globals,
# so that the step's calls go through the wrapper
STAGES = (
    ("x_plane", band_exec, "execute_packed", None),
    ("pitch", plc, "_pitch_search", None),
    ("plc_rows", plc, "plc_rows", _lpc_and_ext),
    ("lpc", plc, "_lpc_fit", None),
    ("excitation", plc, "_fir_residual", None),
    ("extension", plc, "_lpc_synthesis", None),
    ("plc_freq", plc, "celt_plc_freq", _first),
    ("imdct", synthesis, "imdct_blocks", None),
    ("comb_filter", synthesis, "comb_filter_batched", None),
    ("pcm", synthesis, "deemphasis_pcm", _first),
    ("silk_synthesis", pipeline, "silk_synthesis_step", _first),
    ("up48", pipeline, "up48_step", _first),
)


@contextmanager
def record_stages(log: list):
    """While open, each call of a stage appends (name, its output on the
    CPU) to `log`."""
    saved = []

    def wrap(name, fn, pick):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            kept = out if pick is None else pick(out)
            log.append((name, kept.detach().to("cpu", copy=True)))
            return out
        return recorded

    for name, module, attr, pick in STAGES:
        fn = getattr(module, attr, None)
        if fn is None:      # an older checkout without this stage
            continue
        saved.append((module, attr, fn))
        setattr(module, attr, wrap(name, fn, pick))
    try:
        yield log
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def _by_stage(log):
    calls: dict = {}
    for name, t in log:
        calls.setdefault(name, []).append(t)
    return calls


def _stage_err(got, want):
    """Relative error of a float stage (to the largest |value| of its
    rows), or the count of differing integers."""
    if not want.dtype.is_floating_point:
        return float((got != want).sum())
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    return err / scale if scale > 0 else err


def split_errors(make_pipe, frames, S: int, splits: dict) -> dict:
    """The streams of `frames` (one list of S payloads a frame) through
    make_pipe(S) and, for each split (a label and the sizes of its
    batches, summing to S), through one make_pipe(n) a batch.

    Returns, per split label: "pcm", the worst absolute difference of the
    PCM from the whole batch's; "stages", each stage's worst error (see
    _stage_err) over the frames, compared only where the batch ran the
    stage too (a batch without a loss skips the concealment); "first",
    "frame f: stage" of the first difference, or None; and the whole
    batch's "decode_mem" before each frame, on the CPU."""
    whole = make_pipe(S)
    parts = {label: [make_pipe(n) for n in sizes]
             for label, sizes in splits.items()}
    out = {label: {"pcm": 0.0, "stages": {}, "first": None}
           for label in splits}
    mems = []
    for f, batch in enumerate(frames):
        mems.append(whole.state.decode_mem.detach().cpu().clone())
        log: list = []
        with record_stages(log):
            want = whole.step(batch)
        want_calls = _by_stage(log)
        order = list(dict.fromkeys(name for name, _ in log))
        for label, pipes in parts.items():
            res = out[label]
            lo = 0
            errs: dict = {}
            pcm = []
            for pipe in pipes:
                n = pipe.S
                log = []
                with record_stages(log):
                    pcm.append(pipe.step(batch[lo:lo + n]).cpu())
                for name, calls in _by_stage(log).items():
                    for j, got in enumerate(calls):
                        full = want_calls[name][j]
                        r = full.shape[0] // S
                        err = _stage_err(got, full[lo * r:(lo + n) * r])
                        errs[name] = max(errs.get(name, 0.0), err)
                lo += n
            res["pcm"] = max(res["pcm"], float(
                (torch.cat(pcm) - want.cpu()).abs().max()))
            for name, err in errs.items():
                res["stages"][name] = max(res["stages"].get(name, 0.0), err)
            if res["first"] is None:
                bad = [name for name in order if errs.get(name, 0.0) > 0]
                if bad:
                    res["first"] = f"frame {f}: {bad[0]}"
    out["decode_mem"] = mems
    return out


def lossy_frames(batch_fn, S: int, n_frames: int, share: float, seed: int,
                 first_loss: int):
    """(frames, lost): n_frames batches of S streams from batch_fn(S, f,
    lost[:, f]), with a seeded share of packets lost from frame
    first_loss on (S draws a frame, as tests/test_torch_streaming.py
    draws them)."""
    rng = np.random.default_rng(seed)
    lost = np.zeros((S, n_frames), bool)
    for f in range(first_loss, n_frames):
        lost[:, f] = rng.random(S) < share
    return [batch_fn(S, f, lost[:, f]) for f in range(n_frames)], lost
