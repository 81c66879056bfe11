"""CELT band shape coding: theta splits, folding, Hadamard TF transforms.

Host-side symbol stage of the decoder: consumes the range coder, produces
the unit-norm spectrum X (and collapse masks) that the device synthesis
kernels denormalise. Parity: reference `src/celt/bands.rs`
(quant_all_bands:2575, compute_theta:274, haar1:3797, anti_collapse:3220);
normative per RFC 6716 §4.3.4.

Encode/decode are unified like the reference (`encode` flag): the split
logic, allocation rebalance and folding bookkeeping are identical on both
sides, only the leaf PVQ and theta coding differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .modes import (BITRES, CeltMode, QTHETA_OFFSET, QTHETA_OFFSET_TWOPHASE,
                    bits2pulses, get_pulses, pulses2bits)
from .vq import (SPREAD_AGGRESSIVE, alg_quant, alg_unquant, renormalise_vector)

_EXP2_TABLE8 = [16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048]

_BIT_INTERLEAVE = [0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3]
_BIT_DEINTERLEAVE = [0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                     0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF]

_ORDERY = {2: [1, 0],
           4: [3, 0, 2, 1],
           8: [7, 0, 4, 3, 6, 1, 5, 2],
           16: [15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5]}


def lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def _frac_mul16(a: int, b: int) -> int:
    return (16384 + a * b) >> 15


def bitexact_cos(x: int) -> int:
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = (32767 - x2) + _frac_mul16(
        x2, -7651 + _frac_mul16(x2, 8277 + _frac_mul16(-626, x2)))
    return 1 + x2


def bitexact_log2tan(isin: int, icos: int) -> int:
    lc = icos.bit_length()
    ls = isin.bit_length()
    icos <<= 15 - lc
    isin <<= 15 - ls
    return ((ls - lc) * (1 << 11)
            + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
            - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932))


def isqrt32(val: int) -> int:
    return math.isqrt(val)


def compute_qn(N: int, b: int, offset: int, pulse_cap: int, stereo: bool) -> int:
    n2 = 2 * N - 1
    if stereo and N == 2:
        n2 -= 1
    qb = (b + n2 * offset) // n2 if (b + n2 * offset) >= 0 else -((-(b + n2 * offset)) // n2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = _EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> 3))
    qn = ((qn + 1) >> 1) << 1
    assert qn <= 256
    return qn


def haar1(X: np.ndarray, n0: int, stride: int) -> None:
    n0 >>= 1
    s = 0.70710678
    for i in range(stride):
        idx1 = i + stride * 2 * np.arange(n0)
        idx2 = idx1 + stride
        t1 = s * X[idx1]
        t2 = s * X[idx2]
        X[idx1] = t1 + t2
        X[idx2] = t1 - t2


def _interleave_hadamard(X: np.ndarray, n0: int, stride: int, hadamard: bool) -> None:
    N = n0 * stride
    V = X[:N]
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[i::stride] = V[ordery[i] * n0: (ordery[i] + 1) * n0]
    else:
        for i in range(stride):
            tmp[i::stride] = V[i * n0: (i + 1) * n0]
    X[:N] = tmp


def _deinterleave_hadamard(X: np.ndarray, n0: int, stride: int, hadamard: bool) -> None:
    N = n0 * stride
    V = X[:N]
    tmp = np.empty(N, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[ordery[i] * n0: (ordery[i] + 1) * n0] = V[i::stride]
    else:
        for i in range(stride):
            tmp[i * n0: (i + 1) * n0] = V[i::stride]
    X[:N] = tmp


def _stereo_merge(X: np.ndarray, Y: np.ndarray, mid: float, N: int) -> None:
    xp = float(np.dot(X[:N], Y[:N])) * mid
    side = float(np.dot(Y[:N], Y[:N]))
    el = mid * mid + side - 2 * xp
    er = mid * mid + side + 2 * xp
    if er < 6e-4 or el < 6e-4:
        Y[:N] = X[:N]
        return
    lgain = 1.0 / math.sqrt(el)
    rgain = 1.0 / math.sqrt(er)
    l = mid * X[:N]
    r = Y[:N].copy()
    X[:N] = lgain * (l - r)
    Y[:N] = rgain * (l + r)


def stereo_split(X: np.ndarray, Y: np.ndarray, N: int) -> None:
    s = 0.70710678
    l = s * X[:N]
    r = s * Y[:N]
    X[:N] = l + r
    Y[:N] = r - l


def intensity_stereo(mode: CeltMode, X: np.ndarray, Y: np.ndarray,
                     band_e: np.ndarray, band: int, N: int) -> None:
    left = float(band_e[0, band])
    right = float(band_e[1, band])
    norm = 1e-15 + math.sqrt(1e-15 + left * left + right * right)
    a1 = left / norm
    a2 = right / norm
    X[:N] = a1 * X[:N] + a2 * Y[:N]


@dataclass
class BandCtx:
    encode: bool
    resynth: bool
    mode: CeltMode
    i: int = 0
    intensity: int = 0
    spread: int = 0
    tf_change: int = 0
    ec: object = None
    remaining_bits: int = 0
    band_e: np.ndarray = None
    seed: int = 0
    theta_round: int = 0
    disable_inv: bool = False
    avoid_split_noise: bool = False
    plan: object = None  # PlanRecorder (decode-side plan mode) or None


@dataclass
class SplitCtx:
    inv: int = 0
    imid: int = 0
    iside: int = 0
    delta: int = 0
    itheta: int = 0
    qalloc: int = 0


def stereo_itheta(X: np.ndarray, Y: np.ndarray, stereo: bool, N: int) -> int:
    emid = eside = 1e-6
    if stereo:
        m = X[:N] + Y[:N]
        s = X[:N] - Y[:N]
        emid += float(np.dot(m, m))
        eside += float(np.dot(s, s))
    else:
        emid += float(np.dot(X[:N], X[:N]))
        eside += float(np.dot(Y[:N], Y[:N]))
    mid = math.sqrt(emid)
    side = math.sqrt(eside)
    return int(math.floor(0.5 + 16384 * 0.63662 * math.atan2(side, mid)))


def compute_theta(ctx: BandCtx, sctx: SplitCtx, X, Y, N: int, b: list, B: int,
                  B0: int, LM: int, stereo: bool, fill: list) -> None:
    m = ctx.mode
    i = ctx.i
    ec = ctx.ec
    encode = ctx.encode
    inv = 0
    itheta = 0

    pulse_cap = int(m.log_n[i]) + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE if stereo and N == 2
                                 else QTHETA_OFFSET)
    qn = compute_qn(N, b[0], offset, pulse_cap, stereo)
    if stereo and i >= ctx.intensity:
        qn = 1
    if encode:
        itheta = stereo_itheta(X, Y, stereo, N)
    tell = ec.tell_frac()
    if qn != 1:
        if encode:
            if not stereo or ctx.theta_round == 0:
                itheta = (itheta * qn + 8192) >> 14
                if (not stereo and ctx.avoid_split_noise and itheta > 0
                        and itheta < qn):
                    # If this theta would make one side's allocation inject
                    # noise on a transient, snap to a pure split instead.
                    unq = (itheta * 16384) // qn
                    t_imid = bitexact_cos(unq)
                    t_iside = bitexact_cos(16384 - unq)
                    t_delta = _frac_mul16((N - 1) << 7,
                                          bitexact_log2tan(t_iside, t_imid))
                    if t_delta > b[0]:
                        itheta = qn
                    elif t_delta < -b[0]:
                        itheta = 0
            else:
                # Bias quantization towards itheta=0 and itheta=16384
                bias = 32767 // qn if itheta > 8192 else -(32767 // qn)
                down = min(qn - 1, max(0, (itheta * qn + bias) >> 14))
                itheta = down if ctx.theta_round < 0 else down + 1
        if stereo and N > 2:
            p0 = 3
            x = itheta
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            if encode:
                fl = p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0
                fh = p0 * (x + 1) if x <= x0 else (x - x0) + (x0 + 1) * p0
                ec.encode(fl, fh, ft)
            else:
                fs = ec.decode(ft)
                if fs < (x0 + 1) * p0:
                    x = fs // p0
                else:
                    x = x0 + 1 + (fs - (x0 + 1) * p0)
                fl = p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0
                fh = p0 * (x + 1) if x <= x0 else (x - x0) + (x0 + 1) * p0
                ec.update(fl, fh, ft)
                itheta = x
        elif B0 > 1 or stereo:
            if encode:
                ec.enc_uint(itheta, qn + 1)
            else:
                itheta = ec.dec_uint(qn + 1)
        else:
            # triangular pdf
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            if encode:
                if itheta <= qn >> 1:
                    fs = itheta + 1
                    fl = itheta * (itheta + 1) >> 1
                else:
                    fs = qn + 1 - itheta
                    fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
                ec.encode(fl, fl + fs, ft)
            else:
                fm = ec.decode(ft)
                if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                    itheta = (isqrt32(8 * fm + 1) - 1) >> 1
                    fs = itheta + 1
                    fl = itheta * (itheta + 1) >> 1
                else:
                    itheta = (2 * (qn + 1) - isqrt32(8 * (ft - fm - 1) + 1)) >> 1
                    fs = qn + 1 - itheta
                    fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
                ec.update(fl, fl + fs, ft)
        assert itheta >= 0
        itheta = (itheta * 16384) // qn
        if encode and stereo:
            if itheta == 0:
                intensity_stereo(m, X, Y, ctx.band_e, i, N)
            else:
                stereo_split(X, Y, N)
    elif stereo:
        if encode:
            inv = 1 if itheta > 8192 and not ctx.disable_inv else 0
            if inv:
                Y[:N] = -Y[:N]
            intensity_stereo(m, X, Y, ctx.band_e, i, N)
            if b[0] > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
                ec.enc_bit_logp(inv, 2)
            else:
                inv = 0
        else:
            if b[0] > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
                inv = ec.dec_bit_logp(2)
            else:
                inv = 0
            if ctx.disable_inv:
                inv = 0
        itheta = 0
    qalloc = ec.tell_frac() - tell
    b[0] -= qalloc

    if itheta == 0:
        imid = 32767
        iside = 0
        fill[0] &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid = 0
        iside = 32767
        fill[0] &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = _frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid))

    sctx.inv = inv
    sctx.imid = imid
    sctx.iside = iside
    sctx.delta = delta
    sctx.itheta = itheta
    sctx.qalloc = qalloc


def quant_band_n1(ctx: BandCtx, X, Y, lowband_out) -> int:
    ec = ctx.ec
    if ctx.plan is not None:
        ctx.plan.open_call(X, 1, 1, 0, None, False, lowband_out, n1=True)
    channels = [X] if Y is None else [X, Y]
    for x in channels:
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            if ctx.encode:
                sign = 1 if x[0] < 0 else 0
                ec.enc_bits(sign, 1)
            else:
                sign = ec.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        if ctx.resynth:
            x[0] = -1.0 if sign else 1.0
            if ctx.plan is not None:
                ctx.plan.leaf_const(x, x[0])
    if lowband_out is not None:
        lowband_out[0] = X[0]
    if ctx.plan is not None:
        ctx.plan.close_call()
    return 1


def quant_partition(ctx: BandCtx, X: np.ndarray, N: int, b: int, B: int,
                    lowband, LM: int, gain: float, fill: int) -> int:
    m = ctx.mode
    i = ctx.i
    ec = ctx.ec
    B0 = B
    cm = 0

    cache_index = int(m.cache.index[(LM + 1) * m.num_ebands + i])
    cache = m.cache.bits[cache_index:]
    if LM != -1 and b > int(cache[int(cache[0])]) + 12 and N > 2:
        N >>= 1
        Y = X[N:]
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1

        sctx = SplitCtx()
        b_box = [b]
        fill_box = [fill]
        compute_theta(ctx, sctx, X, Y, N, b_box, B, B0, LM, False, fill_box)
        b = b_box[0]
        fill = fill_box[0]
        imid, iside = sctx.imid, sctx.iside
        delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
        mid = imid / 32768.0
        side = iside / 32768.0

        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (N << BITRES >> (5 - LM)))
        mbits = max(0, min(b, (b - delta) // 2))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc

        next_lowband2 = lowband[N:] if lowband is not None else None

        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                 gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                  gain * side, fill >> B) << (B0 >> 1)
        else:
            cm = quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                 gain * side, fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM,
                                  gain * mid, fill)
    else:
        # leaf: PVQ codeword (or folding/noise when no bits remain)
        q = bits2pulses(m, i, LM, b)
        curr_bits = pulses2bits(m, i, LM, q)
        ctx.remaining_bits -= curr_bits
        while ctx.remaining_bits < 0 and q > 0:
            ctx.remaining_bits += curr_bits
            q -= 1
            curr_bits = pulses2bits(m, i, LM, q)
            ctx.remaining_bits -= curr_bits

        if q != 0:
            K = get_pulses(q)
            if ctx.encode:
                cm = alg_quant(X, N, K, ctx.spread, B, ec, gain, ctx.resynth)
            elif ctx.plan is not None:
                # plan mode: pull only the CWRS index off the entropy stream;
                # the index -> pulse-vector walk and all signal math replay
                # on the device (plan.py / ops/band_exec_jax.py)
                from .cwrs import cwrsi, pvq_v
                idx = ec.dec_uint(pvq_v(N, K))
                iy = cwrsi(N, K, idx)
                from .vq import alg_unquant_from_iy
                cm = alg_unquant_from_iy(X, iy, N, K, ctx.spread, B, gain)
                ctx.plan.leaf_pvq(X, N, K, B, ctx.spread, gain, idx)
            else:
                cm = alg_unquant(X, N, K, ctx.spread, B, ec, gain)
        elif ctx.resynth:
            cm_mask = (1 << B) - 1
            fill &= cm_mask
            if not fill:
                X[:N] = 0.0
            else:
                if lowband is None:
                    # noise fill
                    if ctx.plan is not None:
                        ctx.plan.leaf_noise(X, N, gain, ctx.seed)
                    for j in range(N):
                        ctx.seed = lcg_rand(ctx.seed)
                        signed = ctx.seed - (1 << 32) if ctx.seed & 0x80000000 else ctx.seed
                        X[j] = float(signed >> 20)
                    cm = cm_mask
                else:
                    if ctx.plan is not None:
                        ctx.plan.leaf_fold(X, N, lowband, gain, ctx.seed)
                    for j in range(N):
                        ctx.seed = lcg_rand(ctx.seed)
                        tmp = 1.0 / 256
                        if ctx.seed & 0x8000:
                            X[j] = lowband[j] + tmp
                        else:
                            X[j] = lowband[j] - tmp
                    cm = fill
                renormalise_vector(X, N, gain)
    return cm


def quant_band(ctx: BandCtx, X: np.ndarray, N: int, b: int, B: int,
               lowband, LM: int, lowband_out, gain: float,
               lowband_scratch, fill: int) -> int:
    N0 = N
    N_B = N // B
    B0 = B
    time_divide = 0
    recombine = 0
    long_blocks = B0 == 1
    tf_change = ctx.tf_change

    if N == 1:
        return quant_band_n1(ctx, X, None, lowband_out)

    if tf_change > 0:
        recombine = tf_change

    if ctx.plan is not None:
        use_scratch = bool(
            lowband_scratch is not None and lowband is not None
            and (recombine or (N_B & 1) == 0 and tf_change < 0 or B0 > 1))
        ctx.plan.open_call(X, N, B, tf_change, lowband, use_scratch,
                           lowband_out)

    if (lowband_scratch is not None and lowband is not None
            and (recombine or (N_B & 1) == 0 and tf_change < 0 or B0 > 1)):
        lowband_scratch[:N] = lowband[:N]
        lowband = lowband_scratch

    for k in range(recombine):
        if ctx.encode:
            haar1(X, N >> k, 1 << k)
        if lowband is not None:
            haar1(lowband, N >> k, 1 << k)
        fill = _BIT_INTERLEAVE[fill & 0xF] | _BIT_INTERLEAVE[fill >> 4] << 2
    B >>= recombine
    N_B <<= recombine

    while (N_B & 1) == 0 and tf_change < 0:
        if ctx.encode:
            haar1(X, N_B, B)
        if lowband is not None:
            haar1(lowband, N_B, B)
        fill |= fill << B
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    N_B0 = N_B

    if B0 > 1:
        if ctx.encode:
            _deinterleave_hadamard(X, N_B >> recombine, B0 << recombine, long_blocks)
        if lowband is not None:
            _deinterleave_hadamard(lowband, N_B >> recombine,
                                   B0 << recombine, long_blocks)

    cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill)

    if ctx.resynth:
        if B0 > 1:
            _interleave_hadamard(X, N_B >> recombine, B0 << recombine, long_blocks)
        N_B = N_B0
        B = B0
        for _ in range(time_divide):
            B >>= 1
            N_B <<= 1
            cm |= cm >> B
            haar1(X, N_B, B)
        for k in range(recombine):
            cm = _BIT_DEINTERLEAVE[cm]
            haar1(X, N0 >> k, 1 << k)
        B <<= recombine

        if lowband_out is not None:
            n = math.sqrt(N0)
            lowband_out[:N0] = n * X[:N0]
        cm &= (1 << B) - 1
    if ctx.plan is not None:
        ctx.plan.close_call()
    return cm


def quant_band_stereo(ctx: BandCtx, X: np.ndarray, Y: np.ndarray, N: int,
                      b: int, B: int, lowband, LM: int, lowband_out,
                      lowband_scratch, fill: int) -> int:
    if N == 1:
        return quant_band_n1(ctx, X, Y, lowband_out)

    ec = ctx.ec
    orig_fill = fill
    sctx = SplitCtx()
    b_box = [b]
    fill_box = [fill]
    compute_theta(ctx, sctx, X, Y, N, b_box, B, B, LM, True, fill_box)
    b = b_box[0]
    fill = fill_box[0]
    inv, imid, iside = sctx.inv, sctx.imid, sctx.iside
    delta, itheta, qalloc = sctx.delta, sctx.itheta, sctx.qalloc
    mid = imid / 32768.0
    side = iside / 32768.0

    if N == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = itheta > 8192
        ctx.remaining_bits -= qalloc + sbits
        x2, y2 = (Y, X) if c else (X, Y)
        sign = 0
        if sbits:
            if ctx.encode:
                sign = 1 if x2[0] * y2[1] - x2[1] * y2[0] < 0 else 0
                ec.enc_bits(sign, 1)
            else:
                sign = ec.dec_bits(1)
        sign = 1 - 2 * sign
        cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out, 1.0,
                        lowband_scratch, orig_fill)
        if ctx.plan is not None:
            ctx.plan.op_theta2(X, Y, c, sign, mid, side, inv)
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        if ctx.resynth:
            X[0] *= mid
            X[1] *= mid
            Y[0] *= side
            Y[1] *= side
            tmp = X[0]
            X[0] = tmp - Y[0]
            Y[0] = tmp + Y[0]
            tmp = X[1]
            X[1] = tmp - Y[1]
            Y[1] = tmp + Y[1]
    else:
        mbits = max(0, min(b, (b - delta) // 2))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                            1.0, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, Y, N, sbits, B, None, LM, None, side, None,
                             fill >> B)
        else:
            cm = quant_band(ctx, Y, N, sbits, B, None, LM, None, side, None,
                            fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out,
                             1.0, lowband_scratch, fill)

    if ctx.resynth:
        if N != 2:
            if ctx.plan is not None:
                ctx.plan.op_merge(X, Y, N, mid, inv)
            _stereo_merge(X, Y, mid, N)
        if inv:
            Y[:N] = -Y[:N]
    return cm


def _special_hybrid_folding(mode: CeltMode, norm, norm2, start: int, M: int,
                            dual_stereo: int) -> None:
    eb = mode.ebands
    n1 = M * (int(eb[start + 1]) - int(eb[start]))
    n2 = M * (int(eb[start + 2]) - int(eb[start + 1]))
    norm[n1: n2] = norm[2 * n1 - n2: n1]
    if dual_stereo:
        norm2[n1: n2] = norm2[2 * n1 - n2: n1]


def quant_all_bands(encode: bool, mode: CeltMode, start: int, end: int,
                    X_: np.ndarray, Y_, collapse_masks: np.ndarray,
                    band_e, pulses, short_blocks: bool, spread: int,
                    dual_stereo: int, intensity: int, tf_res,
                    total_bits: int, balance: int, ec, LM: int,
                    coded_bands: int, seed: int,
                    complexity: int = 0, disable_inv: bool = False,
                    plan=None) -> int:
    """Shared encode/decode band loop; returns the updated noise seed."""
    eb = mode.ebands
    M = 1 << LM
    B = M if short_blocks else 1
    norm_offset = M * int(eb[start])
    C = 2 if Y_ is not None else 1
    norm_len = M * int(eb[mode.num_ebands - 1]) - norm_offset
    norm = np.zeros(norm_len, np.float64)
    norm2 = np.zeros(norm_len, np.float64) if C == 2 else norm
    lowband_scratch = np.zeros(M * int(eb[mode.num_ebands]), np.float64)

    theta_rdo = encode and Y_ is not None and dual_stereo == 0 and complexity >= 8
    resynth = (not encode) or theta_rdo

    recorder = None
    if plan is not None and not encode:
        from .plan import PlanRecorder
        plan.norm_offset = norm_offset
        plan.norm_len = norm_len
        recorder = PlanRecorder(plan, X_, norm, norm2 if C == 2 else None,
                                lowband_scratch)

    ctx = BandCtx(encode=encode, resynth=resynth, mode=mode,
                  intensity=intensity, spread=spread, ec=ec, band_e=band_e,
                  seed=seed, disable_inv=disable_inv,
                  avoid_split_noise=B > 1, plan=recorder)

    lowband_offset = 0
    update_lowband = True
    for i in range(start, end):
        ctx.i = i
        last = i == end - 1
        X = X_[M * int(eb[i]):]
        Y = Y_[M * int(eb[i]):] if Y_ is not None else None
        N = M * int(eb[i + 1]) - M * int(eb[i])
        tell = ec.tell_frac()

        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= coded_bands - 1:
            den = min(3, coded_bands - i)
            curr_balance = balance // den if balance >= 0 else -((-balance) // den)
            b = max(0, min(16383, min(remaining_bits + 1,
                                      pulses[i] + curr_balance)))
        else:
            b = 0

        if (resynth and (M * int(eb[i]) - N >= M * int(eb[start]) or i == start + 1)
                and (update_lowband or lowband_offset == 0)):
            lowband_offset = i
        if i == start + 1:
            if ctx.plan is not None:
                n1f = M * (int(eb[start + 1]) - int(eb[start]))
                n2f = M * (int(eb[start + 2]) - int(eb[start + 1]))
                ctx.plan.op_hybrid_fold(n1f, n2f, dual_stereo)
            _special_hybrid_folding(mode, norm, norm2, start, M, dual_stereo)

        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        scratch = lowband_scratch
        if i >= mode.effective_ebands:
            X = norm
            Y = norm if Y_ is not None else None
            scratch = None
            if ctx.plan is not None:
                # X redirected into the norm buffer: not representable as a
                # plan — fall back to shipping the decoded spectrum directly
                ctx.plan.plan.direct = True
                ctx.plan = None
        if last and not theta_rdo:
            scratch = None

        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE or B > 1
                                    or tf_change < 0):
            effective_lowband = max(0, M * int(eb[lowband_offset]) - norm_offset - N)
            fold_start = lowband_offset
            while True:
                fold_start -= 1
                if M * int(eb[fold_start]) <= effective_lowband + norm_offset:
                    break
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and M * int(eb[fold_end]) < effective_lowband + norm_offset + N):
                    break
            x_cm = y_cm = 0
            fold_i = fold_start
            while True:
                x_cm |= int(collapse_masks[fold_i * C + 0])
                y_cm |= int(collapse_masks[fold_i * C + C - 1])
                fold_i += 1
                if fold_i >= fold_end:
                    break
        else:
            effective_lowband = -1
            x_cm = y_cm = (1 << B) - 1

        if dual_stereo and i == intensity:
            dual_stereo = 0
            if resynth:
                upto = M * int(eb[i]) - norm_offset
                if ctx.plan is not None:
                    ctx.plan.op_avg_norm(upto)
                norm[:upto] = 0.5 * (norm[:upto] + norm2[:upto])
        if dual_stereo:
            x_cm = quant_band(
                ctx, X, N, b // 2, B,
                norm[effective_lowband:] if effective_lowband != -1 else None,
                LM, None if last else norm[M * int(eb[i]) - norm_offset:],
                1.0, scratch, x_cm)
            y_cm = quant_band(
                ctx, Y, N, b // 2, B,
                norm2[effective_lowband:] if effective_lowband != -1 else None,
                LM, None if last else norm2[M * int(eb[i]) - norm_offset:],
                1.0, scratch, y_cm)
        else:
            if Y is not None:
                x_cm = quant_band_stereo(
                    ctx, X, Y, N, b, B,
                    norm[effective_lowband:] if effective_lowband != -1 else None,
                    LM, None if last else norm[M * int(eb[i]) - norm_offset:],
                    scratch, x_cm | y_cm)
            else:
                x_cm = quant_band(
                    ctx, X, N, b, B,
                    norm[effective_lowband:] if effective_lowband != -1 else None,
                    LM, None if last else norm[M * int(eb[i]) - norm_offset:],
                    1.0, scratch, x_cm | y_cm)
            y_cm = x_cm
        collapse_masks[i * C + 0] = x_cm & 0xFF
        collapse_masks[i * C + C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = b > (N << BITRES)
        ctx.avoid_split_noise = False
    return ctx.seed


def anti_collapse(mode: CeltMode, X_: np.ndarray, collapse_masks: np.ndarray,
                  LM: int, C: int, size: int, start: int, end: int,
                  logE, prev1logE, prev2logE, pulses, seed: int) -> None:
    """Inject noise into collapsed MDCT sub-blocks (decode + resynth parity)."""
    for i in range(start, end):
        N0 = int(mode.ebands[i + 1]) - int(mode.ebands[i])
        depth = ((1 + pulses[i]) // N0) >> LM
        thresh = 0.5 * (2.0 ** (-0.125 * depth))
        sqrt_1 = 1.0 / math.sqrt(N0 << LM)
        for c in range(C):
            prev1 = prev1logE[c, i]
            prev2 = prev2logE[c, i]
            if C == 1 and prev1logE.shape[0] > 1:
                prev1 = max(prev1, prev1logE[1, i])
                prev2 = max(prev2, prev2logE[1, i])
            ediff = max(0.0, float(logE[c, i]) - min(float(prev1), float(prev2)))
            r = 2.0 * (2.0 ** (-ediff))
            if LM == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            base = c * size + (int(mode.ebands[i]) << LM)
            renormalize = False
            for k in range(1 << LM):
                if not (int(collapse_masks[i * C + c]) & (1 << k)):
                    for j in range(N0):
                        seed = lcg_rand(seed)
                        X_[base + (j << LM) + k] = r if seed & 0x8000 else -r
                    renormalize = True
            if renormalize:
                renormalise_vector(X_[base:], N0 << LM, 1.0)
