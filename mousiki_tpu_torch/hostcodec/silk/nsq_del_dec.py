"""SILK delayed-decision noise-shaping quantizer (float).

Behavioral port of the reference's default-quality encoder quantizer
(`src/silk/nsq_del_dec.rs:83` silk_NSQ_del_dec): N
parallel trellis states, each carrying a DECISION_DELAY-sample ring of
tentative decisions; every sample each state spawns two rate-distortion
candidates, the worst head is replaced by the best runner-up, and output
samples are committed with a decision_delay lag from the momentary
winner. The noise-shape feedback filter runs through the warped allpass
chain (`nsq_del_dec.rs:453-486`), matching the warped shaping analysis
(`noise_shape_analysis_flp.rs:246-281`) used at default complexity
(`control_codec.rs:326-340`: warping_q16 > 0 selects this quantizer,
`wrappers_flp.rs:215`).

Q formats are translated to plain float in pulse units (1.0 == one
excitation pulse): the bitstream carries only the pulse integers and the
winner's seed index, so conformance is unaffected; the embedded mirror
decoder advances with exact decoder arithmetic afterwards.
"""

from __future__ import annotations

import math

import numpy as np

from .noise_shape import (HARM_SHAPE_FIR_TAPS, LTP_ORDER, NsqState,
                          QUANT_LEVEL_ADJUST, ShapeControl, _QUANT_OFFSETS)

DECISION_DELAY = 40
MAX_DEL_DEC_STATES = 4
NSQ_LPC_BUF = 32
BIG_RD = 2.0 ** 27  # float stand-in for the i32::MAX >> 4 penalty


def _silk_rand_vec(seed: np.ndarray) -> np.ndarray:
    """Vectorized silk_RAND over int32 (decode_core.silk_rand twin)."""
    return (np.int32(907633515)
            + seed.astype(np.int32) * np.int32(196314165)).astype(np.int32)


def nsq_del_dec(x: np.ndarray, st_nsq: NsqState, ctl: ShapeControl, *,
                signal_type: int, seed: int, nb_subfr: int,
                frame_length: int, ltp_mem_length: int, lpc_order: int,
                pred_coef_q12, ltp_coef_q14, gains_q16, pitch_l,
                ltp_scale_q14: int, nlsf_interp_flag: bool = False,
                n_states: int = MAX_DEL_DEC_STATES, warping: float = 0.0):
    """Run the delayed-decision NSQ over one frame.

    Same state contract as noise_shape.nsq_shaped (persistent NsqState
    buffers in the gain-scaled float domain, unscaled xq history for LTP
    re-whitening). Returns (pulses, seed_used): seed_used is the winner
    state's initial seed index and MUST be what encode_indices codes
    (nsq_del_dec.rs:306 `indices.seed = winner.seed_init`).
    """
    sub = frame_length // nb_subfr
    voiced = signal_type == 2
    # chain/state length: always the full persistent s_ar2 width so the
    # delay-line tail stays interchangeable with nsq_shaped (coefs are
    # zero-padded past ctl's shaping order)
    order = len(st_nsq.s_ar2)
    N = n_states
    pulses = [0] * frame_length
    offset = _QUANT_OFFSETS[1 if voiced else 0][ctl.quant_offset_type]
    lam = ctl.lambda_

    lag = st_nsq.lag_prev
    xq_all = st_nsq.xq                     # unscaled emitted output
    shp = st_nsq.s_ltp_shp                 # scaled shape history

    # --- per-state trellis arrays (axis 0 = state) ----------------------
    seeds = (np.arange(N, dtype=np.int32) + np.int32(seed & 3)) & 3
    seed_init = seeds.copy()
    rd = np.zeros(N)
    lf_ar = np.full(N, st_nsq.s_lf_ar)
    diff = np.full(N, st_nsq.s_diff)
    s_ar2 = np.tile(st_nsq.s_ar2[:order], (N, 1))
    s_lpc = np.zeros((N, NSQ_LPC_BUF + sub))
    s_lpc[:, :NSQ_LPC_BUF] = st_nsq.s_lpc[:NSQ_LPC_BUF]
    # decision-delay rings
    r_rand = np.zeros((N, DECISION_DELAY), np.int32)
    r_q = np.zeros((N, DECISION_DELAY))
    r_xq = np.zeros((N, DECISION_DELAY))
    r_pred = np.zeros((N, DECISION_DELAY))
    r_shape = np.zeros((N, DECISION_DELAY))
    r_shape[:, 0] = shp[ltp_mem_length - 1]

    smpl_buf_idx = 0
    decision_delay = min(DECISION_DELAY, sub)
    if voiced:
        for lk in pitch_l[:nb_subfr]:
            decision_delay = min(decision_delay,
                                 max(int(lk) - LTP_ORDER // 2 - 1, 0))
    elif lag > 0:
        decision_delay = min(decision_delay,
                             max(lag - LTP_ORDER // 2 - 1, 0))
    delayed_gain = np.zeros(DECISION_DELAY)

    s_ltp = np.zeros(ltp_mem_length + frame_length)       # whitened, unscaled
    s_ltp_sc = np.zeros(ltp_mem_length + frame_length)    # scaled
    shp_buf_idx = ltp_mem_length
    ltp_buf_idx = ltp_mem_length
    subfr = 0
    w = warping

    def flush(count, gain, pulses_off, xq_off):
        """Commit `count` delayed samples from the current winner."""
        nonlocal rd
        win = int(np.argmin(rd))
        pen = np.full(N, BIG_RD)
        pen[win] = 0.0
        rd = rd + pen
        last = (smpl_buf_idx + decision_delay) % DECISION_DELAY
        for i in range(count):
            last = (last + DECISION_DELAY - 1) % DECISION_DELAY
            pulses[pulses_off + i - decision_delay] = int(
                math.floor(r_q[win, last] + 0.5))
            xq_all[xq_off + i - decision_delay] = r_xq[win, last] * gain
            shp[shp_buf_idx - decision_delay + i] = r_shape[win, last]
        return win

    for k in range(nb_subfr):
        fo = k * sub
        half = (k >> 1) | (0 if nlsf_interp_flag else 1)
        a = np.asarray(pred_coef_q12[min(half, 1)],
                       np.float64)[:lpc_order] / 4096.0
        ar = a[::-1].copy()
        b = np.asarray(ltp_coef_q14[k * LTP_ORDER:(k + 1) * LTP_ORDER],
                       np.float64) / 16384.0
        ar_shp = np.zeros(order)
        ar_shp[: ctl.ar.shape[1]] = ctl.ar[k]
        gain = max(1, int(gains_q16[k])) / 65536.0
        inv_gain = 1.0 / gain

        rewhite = False
        if voiced:
            lag = int(pitch_l[k])
            if (k & (3 - (2 if nlsf_interp_flag else 0))) == 0:
                if k == 2:
                    # mid-frame winner flush before re-whitening: the new
                    # LPC half needs committed xq history
                    flush(decision_delay, max(1, int(gains_q16[1])) / 65536.0,
                          fo, ltp_mem_length + fo)
                    subfr = 0
                start = ltp_mem_length - lag - lpc_order - LTP_ORDER // 2
                start = max(1, start)
                seg = xq_all[start + fo: ltp_mem_length + fo]
                res = seg.copy()
                for j in range(lpc_order):
                    res[j + 1:] -= a[j] * seg[: len(seg) - j - 1]
                res[: lpc_order] = 0.0
                s_ltp[start: ltp_mem_length] = res
                rewhite = True
                ltp_buf_idx = ltp_mem_length

        # ---- scale_states (nsq_del_dec.rs:690) ---------------------------
        x_sc = x[fo: fo + sub] * inv_gain
        if rewhite:
            ig = inv_gain
            if k == 0:
                ig *= ltp_scale_q14 / 16384.0
            lo = ltp_buf_idx - lag - LTP_ORDER // 2
            s_ltp_sc[lo: ltp_buf_idx] = s_ltp[lo: ltp_buf_idx] * ig
        if gain != st_nsq.prev_gain:
            adj = st_nsq.prev_gain / gain
            shp[shp_buf_idx - ltp_mem_length: shp_buf_idx] *= adj
            if voiced and not rewhite:
                lo = ltp_buf_idx - lag - LTP_ORDER // 2
                s_ltp_sc[lo: ltp_buf_idx - decision_delay] *= adj
            lf_ar *= adj
            diff *= adj
            s_lpc *= adj
            s_ar2 *= adj
            r_pred *= adj
            r_shape *= adj
            st_nsq.prev_gain = gain

        shp_lag = shp_buf_idx - lag + HARM_SHAPE_FIR_TAPS // 2
        pred_lag = ltp_buf_idx - lag + LTP_ORDER // 2
        harm = ctl.harm_shape_gain[k]
        tilt = ctl.tilt[k]
        lf_ma = ctl.lf_ma[k]
        lf_ar_c = ctl.lf_ar[k]
        lpc_off = NSQ_LPC_BUF - 1
        # Warped allpass rotation (nsq_del_dec.rs:453-486) as a lower-
        # triangular matmul: the reference's in-loop chain
        #   new_s[0] = diff + w*s[0];
        #   new_s[j] = s[j-1] + w*(s[j] - new_s[j-1])
        # is a first-order recurrence new_s[j] = rhs[j] - w*new_s[j-1]
        # with rhs[0] = diff + w*s[0], rhs[j] = s[j-1] + w*s[j], whose
        # closed form is new_s = L @ rhs, L[j,m] = (-w)^(j-m). n_ar is
        # then coefs @ new_s -- the persistent s_ar2 keeps the POST-
        # rotation convention (same as noise_shape.nsq_shaped, which this
        # generalizes: w=0 reduces L to the identity shift).
        jj = np.arange(order)
        dd_ = jj[:, None] - jj[None, :]
        Lw = np.where(dd_ >= 0, (-w) ** np.maximum(dd_, 0), 0.0)
        np.fill_diagonal(Lw, 1.0)
        LwT = Lw.T.copy()

        for i in range(sub):
            # shared across states: committed-history reads only
            if voiced:
                ltp_pred = float(b @ s_ltp_sc[pred_lag: pred_lag - 5: -1])
                pred_lag += 1
            else:
                ltp_pred = 0.0
            if lag > 0:
                n_ltp = harm * (0.25 * (shp[shp_lag] + shp[shp_lag - 2])
                                + 0.5 * shp[shp_lag - 1])
                shp_lag += 1
            else:
                n_ltp = 0.0

            seeds = _silk_rand_vec(seeds)
            sgn = np.where(seeds < 0, -1.0, 1.0)

            lpc_pred = s_lpc[:, lpc_off - lpc_order + 1: lpc_off + 1] @ ar

            # noise-shape feedback: states already rotated (see Lw above)
            n_ar = s_ar2 @ ar_shp + lf_ar * tilt

            n_lf = lf_ma * r_shape[:, smpl_buf_idx] + lf_ar_c * lf_ar

            r = x_sc[i] - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp)
            r = sgn * r
            np.clip(r, -31.0, 30.0, out=r)

            # two RD candidates per state (nsq_del_dec.rs:504-566)
            q_ideal = r - offset
            q0 = np.floor(q_ideal)
            if lam > 2.0:
                rdo = 0.5 * lam - 0.5
                q0 = np.where(q_ideal > rdo, np.floor(q_ideal - rdo),
                              np.where(q_ideal < -rdo,
                                       np.floor(q_ideal + rdo),
                                       np.where(q_ideal < 0.0, -1.0, 0.0)))
            v1 = np.where(
                q0 > 0, q0 - QUANT_LEVEL_ADJUST + offset,
                np.where(q0 == 0, offset,
                         np.where(q0 == -1,
                                  offset - (1.0 - QUANT_LEVEL_ADJUST),
                                  q0 + QUANT_LEVEL_ADJUST + offset)))
            v2 = np.where(q0 == 0, v1 + (1.0 - QUANT_LEVEL_ADJUST),
                          np.where(q0 == -1, np.full(N, offset), v1 + 1.0))
            rd1 = lam * np.abs(v1) + (r - v1) ** 2
            rd2 = lam * np.abs(v2) + (r - v2) ** 2
            swap = rd2 < rd1
            c0_q = np.where(swap, v2, v1)
            c1_q = np.where(swap, v1, v2)
            c0_rd = rd + np.where(swap, rd2, rd1)
            c1_rd = rd + np.where(swap, rd1, rd2)

            def cand(vq):
                exc = sgn * vq
                lpc_exc = exc + ltp_pred
                xq_v = lpc_exc + lpc_pred
                d = xq_v - x_sc[i]
                s_lf = d - n_ar
                return exc, lpc_exc, xq_v, d, s_lf, s_lf - n_lf

            (c0_exc, c0_lexc, c0_xq, c0_diff, c0_lfar, c0_shape) = cand(c0_q)
            (c1_exc, c1_lexc, c1_xq, c1_diff, c1_lfar, c1_shape) = cand(c1_q)

            smpl_buf_idx = (smpl_buf_idx + DECISION_DELAY - 1) % DECISION_DELAY
            last = (smpl_buf_idx + decision_delay) % DECISION_DELAY

            # winner by head rd; penalize states whose emitted-sample seed
            # disagrees with the winner's (nsq_del_dec.rs:609)
            win = int(np.argmin(c0_rd))
            bad = r_rand[:, last] != r_rand[win, last]
            c0_rd = np.where(bad, c0_rd + BIG_RD, c0_rd)
            c1_rd = np.where(bad, c1_rd + BIG_RD, c1_rd)

            # replace the worst head with the best runner-up
            mx = int(np.argmax(c0_rd))
            mn = int(np.argmin(c1_rd))
            if c1_rd[mn] < c0_rd[mx]:
                for arr in (seeds, lf_ar, diff):
                    arr[mx] = arr[mn]
                s_ar2[mx] = s_ar2[mn]
                s_lpc[mx] = s_lpc[mn]
                r_rand[mx] = r_rand[mn]
                r_q[mx] = r_q[mn]
                r_xq[mx] = r_xq[mn]
                r_pred[mx] = r_pred[mn]
                r_shape[mx] = r_shape[mn]
                seed_init[mx] = seed_init[mn]
                c0_rd[mx] = c1_rd[mn]
                c0_q[mx] = c1_q[mn]
                c0_exc[mx] = c1_exc[mn]
                c0_lexc[mx] = c1_lexc[mn]
                c0_xq[mx] = c1_xq[mn]
                c0_diff[mx] = c1_diff[mn]
                c0_lfar[mx] = c1_lfar[mn]
                c0_shape[mx] = c1_shape[mn]

            # delayed emission from the winner (nsq_del_dec.rs:643)
            if subfr > 0 or i >= decision_delay:
                pulses[fo + i - decision_delay] = int(
                    math.floor(r_q[win, last] + 0.5))
                xq_all[ltp_mem_length + fo + i - decision_delay] = \
                    r_xq[win, last] * delayed_gain[last]
                shp[shp_buf_idx - decision_delay] = r_shape[win, last]
                s_ltp_sc[ltp_buf_idx - decision_delay] = r_pred[win, last]
            shp_buf_idx += 1
            ltp_buf_idx += 1

            # advance every state with its head candidate; rotate the
            # warped allpass chain with the chosen diff
            rhs = np.empty_like(s_ar2)
            rhs[:, 0] = c0_diff + w * s_ar2[:, 0]
            rhs[:, 1:] = s_ar2[:, :-1] + w * s_ar2[:, 1:]
            s_ar2 = rhs @ LwT
            lf_ar = c0_lfar
            diff = c0_diff
            lpc_off += 1
            s_lpc[:, lpc_off] = c0_xq
            r_xq[:, smpl_buf_idx] = c0_xq
            r_q[:, smpl_buf_idx] = c0_q
            r_pred[:, smpl_buf_idx] = c0_lexc
            r_shape[:, smpl_buf_idx] = c0_shape
            seeds = (seeds
                     + np.floor(c0_q + 0.5).astype(np.int64)).astype(np.int32)
            r_rand[:, smpl_buf_idx] = seeds
            rd = c0_rd
            delayed_gain[smpl_buf_idx] = gain

        s_lpc[:, :NSQ_LPC_BUF] = s_lpc[:, sub: sub + NSQ_LPC_BUF]
        subfr += 1

    # final flush + winner writeback (nsq_del_dec.rs:297-345)
    win = flush(decision_delay,
                max(1, int(gains_q16[nb_subfr - 1])) / 65536.0,
                frame_length, ltp_mem_length + frame_length)
    st_nsq.s_lpc = np.concatenate([
        s_lpc[win, :NSQ_LPC_BUF],
        np.zeros(max(0, len(st_nsq.s_lpc) - NSQ_LPC_BUF))])[
            : len(st_nsq.s_lpc)]
    st_nsq.s_ar2[:order] = s_ar2[win]
    st_nsq.s_lf_ar = float(lf_ar[win])
    st_nsq.s_diff = float(diff[win])
    st_nsq.lag_prev = int(pitch_l[nb_subfr - 1]) if voiced else 0

    xq_all[: ltp_mem_length] = xq_all[frame_length:
                                      frame_length + ltp_mem_length]
    shp[: ltp_mem_length] = shp[frame_length: frame_length + ltp_mem_length]
    return pulses, int(seed_init[win])


# ---------------------------------------------------------------------------
# Native C++ twin (native/silk_host.cpp silk_nsq_del_dec_f64): identical
# float64 algorithm for encode serving throughput; the Python trellis
# above is the tested reference. Falls back transparently.
# ---------------------------------------------------------------------------

_native_fn = None
_native_failed = False


def _load_native():
    global _native_fn, _native_failed
    if _native_fn is not None or _native_failed:
        return _native_fn
    import ctypes as C
    try:
        from . import host_native
        lib = host_native._load()
        fn = getattr(lib, "silk_nsq_del_dec_f64", None)
        if lib is None or fn is None:
            _native_failed = True
            return None
        dp = C.POINTER(C.c_double)
        ip = C.POINTER(C.c_int32)
        fn.restype = C.c_int
        fn.argtypes = [
            dp, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int, C.c_int,
            dp, dp, ip, ip, C.c_int, C.c_int, C.c_int, C.c_double,
            dp, C.c_int, dp, dp, dp, dp, C.c_double, C.c_double,
            dp, dp, dp, dp, dp, ip, ip]
        _native_fn = fn
    except Exception:
        _native_failed = True
        return None
    return _native_fn


def nsq_del_dec_native(x, st_nsq: NsqState, ctl: ShapeControl, *,
                       signal_type: int, seed: int, nb_subfr: int,
                       frame_length: int, ltp_mem_length: int,
                       lpc_order: int, pred_coef_q12, ltp_coef_q14,
                       gains_q16, pitch_l, ltp_scale_q14: int,
                       nlsf_interp_flag: bool = False,
                       n_states: int = MAX_DEL_DEC_STATES,
                       warping: float = 0.0):
    """Native-dispatch variant of nsq_del_dec (same contract); returns
    None when the shared library is unavailable."""
    import ctypes as C
    fn = _load_native()
    if fn is None:
        return None
    dp = C.POINTER(C.c_double)
    ip = C.POINTER(C.c_int32)
    order = len(st_nsq.s_ar2)
    nb = nb_subfr
    voiced = signal_type == 2
    offset = _QUANT_OFFSETS[1 if voiced else 0][ctl.quant_offset_type]

    xf = np.ascontiguousarray(x, np.float64)
    a = np.zeros((2, lpc_order))
    a[0, :] = np.asarray(pred_coef_q12[0], np.float64)[:lpc_order] / 4096.0
    a[1, :] = np.asarray(pred_coef_q12[1], np.float64)[:lpc_order] / 4096.0
    b = np.asarray(ltp_coef_q14, np.float64)[: nb * 5] / 16384.0
    b = np.ascontiguousarray(b)
    gains = np.asarray(gains_q16, np.int32)[:nb].copy()
    pl = np.zeros(nb, np.int32)   # may be empty for unvoiced frames
    src = np.asarray(pitch_l, np.int32)[:nb]
    pl[: len(src)] = src
    ar = np.zeros((nb, order))
    ar[:, : ctl.ar.shape[1]] = ctl.ar[:nb]
    harm = np.ascontiguousarray(ctl.harm_shape_gain[:nb], np.float64)
    tilt = np.ascontiguousarray(ctl.tilt[:nb], np.float64)
    lf_ma = np.ascontiguousarray(ctl.lf_ma[:nb], np.float64)
    lf_ar = np.ascontiguousarray(ctl.lf_ar[:nb], np.float64)

    xq_all = np.ascontiguousarray(st_nsq.xq, np.float64)
    shp = np.ascontiguousarray(st_nsq.s_ltp_shp, np.float64)
    s_lpc = np.ascontiguousarray(st_nsq.s_lpc[:NSQ_LPC_BUF], np.float64)
    s_ar2 = np.ascontiguousarray(st_nsq.s_ar2, np.float64)
    scal = np.array([st_nsq.s_lf_ar, st_nsq.s_diff, st_nsq.prev_gain])
    lag = np.array([st_nsq.lag_prev], np.int32)
    pulses = np.zeros(frame_length, np.int32)

    rc = fn(xf.ctypes.data_as(dp), frame_length, nb, signal_type,
            int(seed), ltp_mem_length, lpc_order,
            a.ctypes.data_as(dp), b.ctypes.data_as(dp),
            gains.ctypes.data_as(ip), pl.ctypes.data_as(ip),
            int(ltp_scale_q14), 1 if nlsf_interp_flag else 0,
            int(n_states), float(warping),
            ar.ctypes.data_as(dp), order,
            harm.ctypes.data_as(dp), tilt.ctypes.data_as(dp),
            lf_ma.ctypes.data_as(dp), lf_ar.ctypes.data_as(dp),
            float(ctl.lambda_), float(offset),
            xq_all.ctypes.data_as(dp), shp.ctypes.data_as(dp),
            s_lpc.ctypes.data_as(dp), s_ar2.ctypes.data_as(dp),
            scal.ctypes.data_as(dp), lag.ctypes.data_as(ip),
            pulses.ctypes.data_as(ip))
    if rc < 0:
        return None
    st_nsq.xq[:] = xq_all
    st_nsq.s_ltp_shp[:] = shp
    st_nsq.s_lpc[:NSQ_LPC_BUF] = s_lpc
    st_nsq.s_ar2[:] = s_ar2
    st_nsq.s_lf_ar = float(scal[0])
    st_nsq.s_diff = float(scal[1])
    st_nsq.prev_gain = float(scal[2])
    st_nsq.lag_prev = int(lag[0])
    return [int(p) for p in pulses], int(rc)


def nsq_del_dec_best(x, st_nsq, ctl, **kw):
    """Native when available (SILK_NSQ_NATIVE=0 forces Python)."""
    import os
    if os.environ.get("SILK_NSQ_NATIVE", "1") != "0":
        r = nsq_del_dec_native(x, st_nsq, ctl, **kw)
        if r is not None:
            return r
    return nsq_del_dec(x, st_nsq, ctl, **kw)
