"""SILK encoder analysis stack (float): burg LPC, 3-stage pitch analysis,
LTP fitting, residual energies.

Behavioral port of the reference quality pipeline
(`burg_modified_flp.rs`, `find_lpc_flp.rs`, `find_pitch_lags_flp.rs`,
`pitch_analysis_core_flp.rs`, `find_ltp_flp.rs`, `quant_ltp_gains.rs` /
`vq_wmat_ec.rs`, `residual_energy_flp.rs`, `ltp_analysis_filter_flp.rs`).
Nothing here is bitstream-normative -- these functions only drive encoder
decisions (which lags/codebooks/gains to USE); the symbol writers in
encoder.py stay exact -- so plain float math is used throughout.

One deliberate deviation: this encoder runs with zero lookahead
(la_pitch = 0), so the 24 ms pitch-LPC window is the *last* 24 ms of
[history | frame] instead of extending 2 ms past the frame end.
"""

from __future__ import annotations

import math

import numpy as np

from . import tables as T

LTP_ORDER = 5

# tuning_parameters.rs
FIND_LPC_COND_FAC = 1e-5
FIND_PITCH_WHITE_NOISE_FRACTION = 1e-3
FIND_PITCH_BANDWIDTH_EXPANSION = 0.99
LTP_CORR_INV_MAX = 0.03
MAX_SUM_LOG_GAIN_DB = 250.0

# pitch_est_tables.rs
PE_SUBFR_LENGTH_MS = 5
PE_LTP_MEM_LENGTH_MS = 20
PE_MAX_LAG_MS = 18
PE_MIN_LAG_MS = 2
PE_D_SRCH_LENGTH = 24
PE_NB_STAGE3_LAGS = 5
PE_NB_CBKS_STAGE2 = 3
PE_NB_CBKS_STAGE2_EXT = 11
PE_SHORTLAG_BIAS = 0.2
PE_PREVLAG_BIAS = 0.2
PE_FLATCONTOUR_BIAS = 0.05

# encoder/state.rs
FIND_PITCH_LPC_WIN_MS = 24       # 20 + 2 * LA_PITCH_MS
FIND_PITCH_LPC_WIN_MS_2_SF = 14  # 10 + 2 * LA_PITCH_MS

# LTP gain-codebook per-vector gains (tables_ltp.rs SILK_LTP_GAIN_VQ_GAIN_Q7)
LTP_GAIN_VQ_GAIN_Q7 = (
    (46, 2, 90, 87, 93, 91, 82, 98),
    (109, 120, 118, 12, 113, 115, 117, 119, 99, 59, 87, 111, 63, 111, 112,
     80),
    (126, 124, 125, 124, 129, 121, 126, 23, 132, 127, 127, 127, 126, 127,
     122, 133, 130, 134, 101, 118, 119, 145, 126, 86, 124, 120, 123, 119,
     170, 173, 107, 109),
)
_LTP_BITS = (T.SILK_LTP_GAIN_BITS_Q5_0, T.SILK_LTP_GAIN_BITS_Q5_1,
             T.SILK_LTP_GAIN_BITS_Q5_2)


# ---------------------------------------------------------------- burg LPC
def burg_modified(x, min_inv_gain, subfr_length, nb_subfr, order):
    """Burg-method LPC over stacked subframes (burg_modified_flp.rs).

    Returns (a, res_nrg): prediction coefficients (residual =
    x[n] - sum_j a[j] * x[n-1-j]) and the residual energy.
    """
    x = np.asarray(x, np.float64)[: subfr_length * nb_subfr]
    c_first = np.zeros(order)
    c_last = np.zeros(order)
    caf = np.zeros(order + 1)
    cab = np.zeros(order + 1)
    af = np.zeros(order)

    c0 = float(x @ x)
    for s in range(nb_subfr):
        xs = x[s * subfr_length:(s + 1) * subfr_length]
        for n in range(1, order + 1):
            c_first[n - 1] += float(xs[: subfr_length - n] @ xs[n:])
    c_last[:] = c_first

    base = c0 + FIND_LPC_COND_FAC * c0 + 1e-9
    caf[0] = base
    cab[0] = base
    inv_gain = 1.0
    reached_max = False

    for n in range(order):
        for s in range(nb_subfr):
            xs = x[s * subfr_length:(s + 1) * subfr_length]
            tmp1 = xs[n]
            tmp2 = xs[subfr_length - n - 1]
            for k in range(n):
                c_first[k] -= xs[n] * xs[n - k - 1]
                c_last[k] -= xs[subfr_length - n - 1] * xs[subfr_length - n + k]
                tmp1 += xs[n - k - 1] * af[k]
                tmp2 += xs[subfr_length - n + k] * af[k]
            for k in range(n + 1):
                caf[k] -= tmp1 * xs[n - k]
                cab[k] -= tmp2 * xs[subfr_length - n + k - 1]

        tmp1 = c_first[n]
        tmp2 = c_last[n]
        for k in range(n):
            tmp1 += c_last[n - k - 1] * af[k]
            tmp2 += c_first[n - k - 1] * af[k]
        caf[n + 1] = tmp1
        cab[n + 1] = tmp2

        num = cab[n + 1]
        nrg_b = cab[0]
        nrg_f = caf[0]
        for k in range(n):
            num += cab[n - k] * af[k]
            nrg_b += cab[k + 1] * af[k]
            nrg_f += caf[k + 1] * af[k]
        if nrg_f <= 0.0 or nrg_b <= 0.0:
            break
        rc = -2.0 * num / (nrg_f + nrg_b)
        rc = min(0.99999, max(-0.99999, rc))

        next_inv_gain = inv_gain * (1.0 - rc * rc)
        if next_inv_gain <= min_inv_gain:
            rc = math.sqrt(max(0.0, 1.0 - min_inv_gain / inv_gain))
            if num > 0.0:
                rc = -rc
            inv_gain = min_inv_gain
            reached_max = True
        else:
            inv_gain = next_inv_gain

        half = (n + 1) // 2
        for k in range(half):
            t_l = af[k]
            t_r = af[n - k - 1]
            af[k] = t_l + rc * t_r
            af[n - k - 1] = t_r + rc * t_l
        af[n] = rc

        if reached_max:
            af[n + 1: order] = 0.0
            break

        for k in range(n + 2):
            t_l = caf[k]
            t_r = cab[n + 1 - k]
            caf[k] = t_l + rc * t_r
            cab[n + 1 - k] = t_r + rc * t_l

    a = -af[:order]
    if reached_max:
        c0_adj = c0
        for s in range(nb_subfr):
            xs = x[s * subfr_length: s * subfr_length + order]
            c0_adj -= float(xs @ xs)
        res_nrg = c0_adj * inv_gain
    else:
        nrg_f = caf[0]
        t1 = 1.0
        for k in range(order):
            nrg_f += caf[k + 1] * af[k]
            t1 += af[k] * af[k]
        res_nrg = nrg_f - FIND_LPC_COND_FAC * c0 * t1
    return a, float(max(res_nrg, 1e-12))


def lpc_analysis_filter(x, a):
    """res[n] = x[n] - sum_j a[j] x[n-1-j]; first len(a) samples zeroed
    (lpc_analysis_filter_flp.rs)."""
    x = np.asarray(x, np.float64)
    res = x.copy()
    for j, aj in enumerate(np.asarray(a, np.float64)):
        res[j + 1:] -= aj * x[: len(x) - j - 1]
    res[: len(a)] = 0.0
    return res


def a_to_nlsf_q15(a, order, delta_min_q15):
    """Float AR coefficients -> stabilized NLSF_Q15 (a2nlsf semantics via
    the P/Q root method)."""
    from .decode_params import nlsf_stabilize
    a = np.asarray(a, np.float64)[:order]
    poly = np.concatenate([[1.0], -a])
    p = np.concatenate([poly, [0.0]]) + np.concatenate([[0.0], poly[::-1]])
    q = np.concatenate([poly, [0.0]]) - np.concatenate([[0.0], poly[::-1]])
    p = np.polynomial.polynomial.polydiv(p[::-1], [1.0, 1.0])[0][::-1]
    q = np.polynomial.polynomial.polydiv(q[::-1], [-1.0, 1.0])[0][::-1]
    angles = []
    for pol in (p, q):
        roots = np.roots(pol)
        ang = np.angle(roots)
        angles.extend(a0 for a0 in ang if 1e-5 < a0 < np.pi - 1e-5)
    angles = sorted(angles)[:order]
    while len(angles) < order:
        angles.append((len(angles) + 1) * np.pi / (order + 1))
    nlsf = [int(min(32767, max(0, round(a0 / np.pi * 32768))))
            for a0 in angles]
    nlsf_stabilize(nlsf, delta_min_q15, order)
    return nlsf


def find_lpc(x_pre, nb_subfr, subfr_length, order, min_inv_gain,
             prev_nlsf_q15, use_interp, first_frame, delta_min_q15):
    """find_lpc_flp.rs: burg LPC + optional interpolated-NLSF search.

    x_pre: nb_subfr chunks of (order + subfr_length) gain-scaled samples.
    Returns (nlsf_q15, interp_q2, res_nrg).
    """
    from .decode_params import nlsf2a
    chunk = subfr_length + order
    interp_q2 = 4
    a, res_nrg = burg_modified(x_pre, min_inv_gain, chunk, nb_subfr, order)

    if use_interp and not first_frame and nb_subfr == 4:
        a2, rn2 = burg_modified(x_pre[2 * chunk:], min_inv_gain, chunk, 2,
                                order)
        res_nrg -= rn2
        nlsf_q15 = a_to_nlsf_q15(a2, order, delta_min_q15)
        res_nrg_2nd = np.inf
        head = np.asarray(x_pre[: 2 * chunk], np.float64)
        valid = subfr_length - order if subfr_length > order else subfr_length
        for k in range(3, -1, -1):
            nlsf_i = [int(p + ((k * (c - p)) >> 2))
                      for p, c in zip(prev_nlsf_q15, nlsf_q15)]
            a_i = np.asarray(nlsf2a(nlsf_i, order), np.float64) / 4096.0
            res = lpc_analysis_filter(head, a_i)
            r0 = res[order: order + valid]
            r1 = res[order + chunk: order + chunk + valid]
            nrg_i = float(r0 @ r0) + float(r1 @ r1)
            if nrg_i < res_nrg:
                res_nrg = nrg_i
                interp_q2 = k
            elif nrg_i > res_nrg_2nd:
                break
            res_nrg_2nd = nrg_i
    else:
        nlsf_q15 = a_to_nlsf_q15(a, order, delta_min_q15)

    return nlsf_q15, interp_q2, res_nrg


# ------------------------------------------------------------ downsamplers
_DOWN2_C0 = 9872.0 / 65536.0
_DOWN2_C1 = -25727.0 / 65536.0
_COEFS_2_3 = T.SILK_RESAMPLER_2_3_COEFS_LQ


def _down2(x):
    """Half-band allpass decimator (resampler_down2.rs), float, zero state."""
    n2 = len(x) // 2
    x = np.asarray(x, np.float64)
    out = np.empty(n2)
    s0 = s1 = 0.0
    for k in range(n2):
        in0 = x[2 * k]
        y = in0 - s0
        w = y + y * _DOWN2_C1
        o = s0 + w
        s0 = in0 + w
        in1 = x[2 * k + 1]
        y = in1 - s1
        w = y * _DOWN2_C0
        o += s1 + w
        s1 = in1 + w
        out[k] = 0.5 * o
    return out


def _down2_3(x):
    """2/3 decimator (resampler_down2_3.rs), float, zero state."""
    x = np.asarray(x, np.float64)
    a0 = _COEFS_2_3[0] / 16384.0
    a1 = _COEFS_2_3[1] / 16384.0
    # FIR taps: reference scales buf Q8, coefs Q16, >>6 => net /16384
    f0, f1, f2, f3 = (c / 16384.0 for c in _COEFS_2_3[2:6])
    # AR2 filter (resampler_private_ar2 semantics, float)
    buf = np.zeros(len(x) + 4)
    s0 = s1 = 0.0
    for i, v in enumerate(x):
        o = v + s0
        buf[4 + i] = o
        s0 = s1 + o * a0
        s1 = o * a1
    out = np.empty(2 * (len(x) // 3))
    j = 0
    i = 0
    n = len(x)
    while n > 2:
        out[j] = buf[i] * f0 + buf[i + 1] * f1 + buf[i + 2] * f3 \
            + buf[i + 3] * f2
        out[j + 1] = buf[i + 1] * f2 + buf[i + 2] * f3 + buf[i + 3] * f1 \
            + buf[i + 4] * f0
        j += 2
        i += 3
        n -= 3
    return out[:j]


def _xcorr(target, basis, max_len):
    """xcorr[d] = target . basis[d:d+len(target)] for d in 0..max_len-1."""
    n = len(target)
    return np.array([float(target @ basis[d: d + n])
                     for d in range(max_len)])


def _sat16(v):
    return min(32767.0, max(-32768.0, v))


# --------------------------------------------------------- pitch analysis
def pitch_analysis_core(frame, prev_lag, thr1, thr2, fs_khz, complexity,
                        nb_subfr, ltp_corr_in):
    """3-stage open-loop pitch search (pitch_analysis_core_flp.rs).

    frame: (20 + nb_subfr*5) ms of LPC residual at fs_khz.
    Returns (voiced, pitch_l, lag_index, contour_index, ltp_corr).
    """
    frame = np.asarray(frame, np.float64)
    frame_length_ms = PE_LTP_MEM_LENGTH_MS + nb_subfr * PE_SUBFR_LENGTH_MS
    frame_length = frame_length_ms * fs_khz
    frame_8 = frame_length_ms * 8
    frame_4 = frame_length_ms * 4
    sf_length = PE_SUBFR_LENGTH_MS * fs_khz
    sf_8 = PE_SUBFR_LENGTH_MS * 8
    sf_4 = PE_SUBFR_LENGTH_MS * 4
    min_lag = PE_MIN_LAG_MS * fs_khz
    min_lag_8 = PE_MIN_LAG_MS * 8
    max_lag = PE_MAX_LAG_MS * fs_khz - 1
    max_lag_8 = PE_MAX_LAG_MS * 8 - 1
    MIN4, MAX4 = PE_MIN_LAG_MS * 4, PE_MAX_LAG_MS * 4
    unvoiced = (1, [0] * nb_subfr, 0, 0, 0.0)

    if fs_khz == 16:
        sig8 = _down2(frame[:frame_length])
    elif fs_khz == 12:
        sig8 = _down2_3(frame[:frame_length])
    else:
        sig8 = frame[:frame_length].copy()
    sig4 = _down2(sig8[:frame_8])
    # one-tap LPF with int16 saturation semantics
    for i in range(frame_4 - 1, 0, -1):
        sig4[i] = _sat16(sig4[i] + sig4[i - 1])

    # ---- stage 1: coarse search at 4 kHz, 2 blocks of 2 subframes ------
    C = np.zeros(MAX4 + 1)
    tgt = sf_4 << 2
    for _k in range(nb_subfr >> 1):
        target = sig4[tgt: tgt + sf_8]
        basis0 = tgt - MAX4
        xc = _xcorr(target, sig4[basis0:], MAX4 - MIN4 + 1)  # lag MAX4..MIN4
        bi = tgt - MIN4
        seg = sig4[bi: bi + sf_8]
        norm = float(target @ target) + float(seg @ seg) + sf_8 * 4000.0
        C[MIN4] += 2.0 * xc[MAX4 - MIN4] / norm
        for d in range(MIN4 + 1, MAX4 + 1):
            bi -= 1
            norm += sig4[bi] * sig4[bi] \
                - sig4[bi + sf_8] * sig4[bi + sf_8]
            C[d] += 2.0 * xc[MAX4 - d] / norm
        tgt += sf_8

    for i in range(MIN4, MAX4 + 1):
        C[i] -= C[i] * i / 4096.0

    length_d_srch = 4 + 2 * complexity
    order = np.argsort(-C[MIN4: MAX4 + 1])[:length_d_srch]
    cmax = float(C[MIN4 + order[0]])
    if cmax < 0.2:
        return unvoiced

    threshold = thr1 * cmax
    d_srch = []
    for idx in order:
        if C[MIN4 + idx] > threshold:
            d_srch.append(int(idx + MIN4) << 1)
        else:
            break
    length_d_srch = len(d_srch)

    d_comp = np.zeros(MAX4 * 2 + 10, np.int32)
    for d in d_srch:
        d_comp[d] = 1
    # forward dilation passes (reference saturating-adds i16; only
    # positivity is tested downstream, so clamp to keep the growth finite)
    for i in range(min_lag_8 + 3, max_lag_8 + 4):
        d_comp[i] = min(100, d_comp[i] + d_comp[i - 1] + d_comp[i - 2])
    d_srch = [i for i in range(min_lag_8, max_lag_8 + 1)
              if d_comp[i + 1] > 0][:PE_D_SRCH_LENGTH]
    for i in range(min_lag_8 + 3, max_lag_8 + 4):
        d_comp[i] = min(100, d_comp[i] + d_comp[i - 1] + d_comp[i - 2]
                        + d_comp[i - 3])
    cand_lags = [i - 2 for i in range(min_lag_8, max_lag_8 + 4)
                 if d_comp[i] > 0]

    # ---- stage 2: per-subframe normalized correlations at 8 kHz --------
    C2 = np.zeros((nb_subfr, MAX4 * 2 + 5))
    tgt = PE_LTP_MEM_LENGTH_MS * 8
    for k in range(nb_subfr):
        target = sig8[tgt: tgt + sf_8]
        e_t = float(target @ target) + 1.0
        for d in cand_lags:
            basis = sig8[tgt - d: tgt - d + sf_8]
            cc = float(basis @ target)
            if cc > 0.0:
                C2[k][d] = 2.0 * cc / (float(basis @ basis) + e_t)
        tgt += sf_8

    use_10ms = nb_subfr != 4
    if use_10ms:
        cb2 = np.asarray(T.SILK_CB_LAGS_STAGE2_10_MS, np.int64)
        nb_cbk = cb2.shape[1]
    else:
        cb2 = np.asarray(T.SILK_CB_LAGS_STAGE2, np.int64)
        nb_cbk = (PE_NB_CBKS_STAGE2_EXT if fs_khz == 8 and complexity > 0
                  else PE_NB_CBKS_STAGE2)

    if prev_lag > 0:
        pl = prev_lag
        if fs_khz == 12:
            pl = (pl << 1) // 3
        elif fs_khz == 16:
            pl >>= 1
        prev_lag_log2 = math.log2(max(pl, 1))
    else:
        prev_lag_log2 = 0.0

    ccmax, ccmax_b = 0.0, -1000.0
    cbimax, lag = 0, -1
    for d in d_srch:
        cc = [sum(C2[i][d + int(cb2[i][j])] for i in range(nb_subfr))
              for j in range(nb_cbk)]
        j_best = int(np.argmax(cc))
        ccmax_new = cc[j_best]
        lag_log2 = math.log2(d)
        ccmax_new_b = ccmax_new - PE_SHORTLAG_BIAS * nb_subfr * lag_log2
        if prev_lag > 0:
            delta = (lag_log2 - prev_lag_log2) ** 2
            ccmax_new_b -= PE_PREVLAG_BIAS * nb_subfr * ltp_corr_in \
                * delta / (delta + 0.5)
        if ccmax_new_b > ccmax_b and ccmax_new > nb_subfr * thr2:
            ccmax_b = ccmax_new_b
            ccmax = ccmax_new
            lag = d
            cbimax = j_best

    if lag == -1:
        return unvoiced
    ltp_corr = ccmax / nb_subfr

    if fs_khz > 8:
        # ---- stage 3: refine at the native rate -------------------------
        if fs_khz == 12:
            lag = (lag * 3 + 1) >> 1
        else:
            lag <<= 1
        lag = min(max(lag, min_lag), max_lag)
        start_lag = max(lag - 2, min_lag)
        end_lag = min(lag + 2, max_lag)
        if nb_subfr == 4:
            cb3 = np.asarray(T.SILK_CB_LAGS_STAGE3, np.int64)
            lag_range = T.SILK_LAG_RANGE_STAGE3[complexity]
            nb_cbk3 = int(T.SILK_NB_CBK_SEARCHS_STAGE3[complexity])
        else:
            cb3 = np.asarray(T.SILK_CB_LAGS_STAGE3_10_MS, np.int64)
            lag_range = T.SILK_LAG_RANGE_STAGE3_10_MS
            nb_cbk3 = cb3.shape[1]

        # precompute per-subframe xcorr/energy over the contour lag spans
        cross3 = np.zeros((nb_subfr, nb_cbk3, PE_NB_STAGE3_LAGS))
        energy3 = np.zeros((nb_subfr, nb_cbk3, PE_NB_STAGE3_LAGS))
        tgt = sf_length << 2
        for k in range(nb_subfr):
            lo, hi = int(lag_range[k][0]), int(lag_range[k][1])
            target = frame[tgt: tgt + sf_length]
            xc = _xcorr(target, frame[tgt - start_lag - hi:],
                        hi - lo + 1)
            scr_c = xc[::-1]  # index by (lag - lo)
            bi = tgt - (start_lag + lo)
            e = float(frame[bi: bi + sf_length] @ frame[bi: bi + sf_length])
            scr_e = np.empty(hi - lo + 1)
            scr_e[0] = e
            for i in range(1, hi - lo + 1):
                e += frame[bi - i] * frame[bi - i] \
                    - frame[bi + sf_length - i] * frame[bi + sf_length - i]
                scr_e[i] = e
            for ci in range(nb_cbk3):
                idx = int(cb3[k][ci]) - lo
                for j in range(PE_NB_STAGE3_LAGS):
                    cross3[k][ci][j] = scr_c[idx + j]
                    energy3[k][ci][j] = scr_e[idx + j]
            tgt += sf_length

        tgt0 = PE_LTP_MEM_LENGTH_MS * fs_khz
        seg = frame[tgt0: tgt0 + nb_subfr * sf_length]
        e_tmp = float(seg @ seg) + 1.0
        contour_bias = PE_FLATCONTOUR_BIAS / lag
        ccmax = -1000.0
        lag_new = lag
        cbimax = 0
        for li, d in enumerate(range(start_lag, end_lag + 1)):
            for j in range(nb_cbk3):
                cc = float(cross3[:, j, li].sum())
                ee = e_tmp + float(energy3[:, j, li].sum())
                v = (2.0 * cc / ee) * (1.0 - contour_bias * j) \
                    if cc > 0.0 else 0.0
                if d + int(cb3[0][j]) > max_lag:
                    v = 0.0
                if v > ccmax:
                    ccmax = v
                    lag_new = d
                    cbimax = j
        pitch_l = [min(max(lag_new + int(cb3[k][cbimax]), min_lag),
                       PE_MAX_LAG_MS * fs_khz) for k in range(nb_subfr)]
        return 0, pitch_l, lag_new - min_lag, cbimax, ltp_corr
    else:
        pitch_l = [min(max(lag + int(cb2[k][cbimax]), min_lag_8),
                       PE_MAX_LAG_MS * 8) for k in range(nb_subfr)]
        return 0, pitch_l, lag - min_lag_8, cbimax, ltp_corr


def _schur(c, order):
    """Schur recursion -> (reflection coefficients, residual energy).

    Mirrors silk_schur_flp (schur_flp.rs): the rc denominator is the
    UPDATED backward error c[0][1], and the residual is its final value."""
    C = np.stack([np.asarray(c[: order + 1], np.float64).copy(),
                  np.asarray(c[: order + 1], np.float64).copy()])
    rc = np.zeros(order)
    for k in range(order):
        rck = -C[0, k + 1] / max(C[1, 0], 1e-9)
        rc[k] = rck
        c1 = C[0, k + 1: order + 1].copy()
        c2 = C[1, : order - k].copy()
        C[0, k + 1: order + 1] = c1 + c2 * rck
        C[1, : order - k] = c2 + c1 * rck
    return rc, float(C[1, 0])


def _k2a(rc):
    order = len(rc)
    a = np.zeros(order)
    for k in range(order):
        a[:k] = a[:k] + rc[k] * a[k - 1::-1][:k]
        a[k] = rc[k]
    return -a


def find_pitch_lags(xbuf, frame_length, fs_khz, nb_subfr, *, prev_lag,
                    prev_signal_type_voiced, ltp_corr_prev, speech_activity,
                    input_tilt=0.0, active=True, first_frame=False,
                    complexity=2, thr_base=0.7, pitch_lpc_order=16):
    """find_pitch_lags_flp.rs with la_pitch = 0.

    xbuf = [20 ms history | frame] at fs_khz. Returns
    (res, voiced, pitch_l, lag_index, contour_index, ltp_corr, pred_gain).
    """
    xbuf = np.asarray(xbuf, np.float64)
    win_ms = (FIND_PITCH_LPC_WIN_MS if nb_subfr == 4
              else FIND_PITCH_LPC_WIN_MS_2_SF)
    win_len = win_ms * fs_khz
    la = 2 * fs_khz
    xw = xbuf[-win_len:].copy()
    k = np.arange(la)
    xw[:la] *= np.sin(0.5 * np.pi * (k + 0.5) / la)
    xw[-la:] *= np.sin(0.5 * np.pi * (la - k - 0.5) / la)

    order = min(pitch_lpc_order, 16)
    ac = np.array([float(xw[: len(xw) - i] @ xw[i:])
                   for i in range(order + 1)])
    ac[0] += ac[0] * FIND_PITCH_WHITE_NOISE_FRACTION + 1.0
    rc, res_nrg = _schur(ac, order)
    pred_gain = ac[0] / max(res_nrg, 1.0)
    a = _k2a(rc)
    f = FIND_PITCH_BANDWIDTH_EXPANSION
    for i in range(order):
        a[i] *= f
        f *= FIND_PITCH_BANDWIDTH_EXPANSION
    res = lpc_analysis_filter(xbuf, a)

    if active and not first_frame:
        thr = 0.6
        thr -= 0.004 * order
        thr -= 0.1 * speech_activity
        thr -= 0.15 * (1.0 if prev_signal_type_voiced else 0.0)
        thr -= 0.1 * input_tilt
        found, pitch_l, lag_index, contour_index, ltp_corr = \
            pitch_analysis_core(res, prev_lag, thr_base, thr, fs_khz,
                                complexity, nb_subfr, ltp_corr_prev)
        voiced = found == 0
    else:
        voiced = False
        pitch_l = [0] * nb_subfr
        lag_index = contour_index = 0
        ltp_corr = 0.0
    return res, voiced, pitch_l, lag_index, contour_index, ltp_corr, \
        pred_gain


# ------------------------------------------------------------------- LTP
def find_ltp(res, ltp_mem_length, pitch_l, subfr_length, nb_subfr):
    """Per-subframe LTP correlations, normalized (find_ltp_flp.rs).

    Returns (XX[nb,5,5], xX[nb,5])."""
    res = np.asarray(res, np.float64)
    XX = np.zeros((nb_subfr, LTP_ORDER, LTP_ORDER))
    xX = np.zeros((nb_subfr, LTP_ORDER))
    r0 = ltp_mem_length
    for k in range(nb_subfr):
        lag = int(pitch_l[k])
        lag_ptr = r0 - (lag + LTP_ORDER // 2)
        corr_len = subfr_length + LTP_ORDER - 1
        win = res[lag_ptr: lag_ptr + corr_len]
        # corr_matrix: XX[i][j] = sum win[order-1-i+n] win[order-1-j+n]
        M = np.stack([win[LTP_ORDER - 1 - i: LTP_ORDER - 1 - i + subfr_length]
                      for i in range(LTP_ORDER)])
        XX[k] = M @ M.T
        tgt = res[r0: r0 + subfr_length]
        xX[k] = M @ tgt
        e_seg = res[r0: r0 + subfr_length + LTP_ORDER]
        denom = max(float(e_seg @ e_seg),
                    LTP_CORR_INV_MAX * 0.5 * (XX[k][0, 0] + XX[k][-1, -1])
                    + 1.0)
        XX[k] /= denom
        xX[k] /= denom
        r0 += subfr_length
    return XX, xX


def quant_ltp_gains(XX, xX, subfr_len, nb_subfr, sum_log_gain_q7):
    """RD-optimal LTP codebook selection (quant_ltp_gains.rs /
    vq_wmat_ec.rs, float metric).

    Returns (b (nb,5) float taps, cbk_index, per_index,
    new_sum_log_gain_q7, pred_gain_db)."""
    best = None
    max_db_q7 = int(MAX_SUM_LOG_GAIN_DB / 6.0 * 128 + 0.5)
    for p in range(3):
        cb = np.asarray(T.SILK_LTP_VQ_PTRS_Q14[p], np.float64) / 128.0
        gains_q7 = LTP_GAIN_VQ_GAIN_Q7[p]
        cl_q5 = _LTP_BITS[p]
        rate_dist = 0.0
        res_nrg_tot = 0.0
        slg = sum_log_gain_q7
        idxs = []
        for k in range(nb_subfr):
            log_target = max_db_q7 - slg + (7 << 7)
            max_gain_q7 = 2.0 ** (log_target / 128.0) - 0.4 * 128.0
            # residual energy ratio per codebook vector:
            # 1.001 + b XX b - 2 b.xX  (Q15-normalized in the reference)
            quad = np.einsum("ij,jk,ik->i", cb, XX[k], cb)
            lin = cb @ xX[k]
            res = 1.001 + quad - 2.0 * lin
            penalty = np.maximum(
                0.0, 128.0 * np.asarray(gains_q7) - max_gain_q7) / 2048.0
            res_pen = res + penalty
            ok = res_pen > 0
            rd = np.where(
                ok,
                subfr_len * 128.0 * np.log2(np.maximum(res_pen, 1e-9))
                + 4.0 * np.asarray(cl_q5, np.float64),
                np.inf)
            i_best = int(np.argmin(rd))
            idxs.append(i_best)
            rate_dist += float(rd[i_best])
            res_nrg_tot += float(max(res_pen[i_best], 1e-9))
            g7 = 0.4 * 128.0 + gains_q7[i_best]
            slg = max(0, int(slg + round(128.0 * math.log2(max(g7, 1e-9))
                                         - (7 << 7))))
        if best is None or rate_dist <= best[0]:
            best = (rate_dist, p, idxs, slg, res_nrg_tot)
    _, per_index, cbk_index, new_slg, res_nrg_tot = best
    cb = np.asarray(T.SILK_LTP_VQ_PTRS_Q14[per_index], np.float64) / 128.0
    b = np.stack([cb[i] for i in cbk_index])
    res_mean = res_nrg_tot / (2 if nb_subfr == 2 else 4)
    pred_gain_db = -3.0 * math.log2(max(res_mean, 1e-9))
    return b, cbk_index, per_index, new_slg, pred_gain_db


def ltp_analysis_filter(x, x_ptr_offset, b, pitch_l, inv_gains,
                        subfr_length, nb_subfr, order):
    """LTP-whiten + gain-scale chunks for LPC analysis
    (ltp_analysis_filter_flp.rs). Returns nb_subfr chunks of
    (order + subfr_length) samples, concatenated."""
    x = np.asarray(x, np.float64)
    chunk = subfr_length + order
    out = np.empty(nb_subfr * chunk)
    xp = x_ptr_offset
    for k in range(nb_subfr):
        lag = int(pitch_l[k])
        lag_base = xp - lag
        taps = np.asarray(b[k], np.float64)
        idx = np.arange(chunk)
        pred = np.zeros(chunk)
        for t in range(LTP_ORDER):
            off = LTP_ORDER // 2 - t  # +2..-2
            pred += taps[t] * x[lag_base + idx + off]
        out[k * chunk:(k + 1) * chunk] = \
            (x[xp: xp + chunk] - pred) * inv_gains[k]
        xp += subfr_length
    return out


def scale_chunks(x, x_ptr_offset, inv_gains, subfr_length, nb_subfr, order):
    """Unvoiced variant: gain-scaled chunks without LTP whitening."""
    x = np.asarray(x, np.float64)
    chunk = subfr_length + order
    out = np.empty(nb_subfr * chunk)
    xp = x_ptr_offset
    for k in range(nb_subfr):
        out[k * chunk:(k + 1) * chunk] = x[xp: xp + chunk] * inv_gains[k]
        xp += subfr_length
    return out


def residual_energy(x_pre, a_halves, gains, subfr_length, nb_subfr, order):
    """Per-subframe residual energies (residual_energy_flp.rs).

    x_pre: the gain-scaled LPC input chunks; a_halves: [a_half0, a_half1]
    float coefficient vectors. Energies are rescaled by gains^2."""
    shift = order + subfr_length
    block = 2 * shift
    nrgs = np.zeros(nb_subfr)
    res = lpc_analysis_filter(x_pre[:block], a_halves[0])
    r0 = res[order: order + subfr_length]
    r1 = res[order + shift: order + shift + subfr_length]
    nrgs[0] = gains[0] * gains[0] * float(r0 @ r0)
    nrgs[1] = gains[1] * gains[1] * float(r1 @ r1)
    if nb_subfr == 4:
        res = lpc_analysis_filter(x_pre[block: 2 * block], a_halves[1])
        r0 = res[order: order + subfr_length]
        r1 = res[order + shift: order + shift + subfr_length]
        nrgs[2] = gains[2] * gains[2] * float(r0 @ r0)
        nrgs[3] = gains[3] * gains[3] * float(r1 @ r1)
    return nrgs
