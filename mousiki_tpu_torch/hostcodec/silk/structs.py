"""SILK decoder state structures (parity: reference src/silk/decoder_state.rs,
decoder_control.rs, decoder_set_fs.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_FRAMES_PER_PACKET = 3
MAX_NB_SUBFR = 4
MAX_LPC_ORDER = 16
MIN_LPC_ORDER = 10
SUB_FRAME_LENGTH_MS = 5
MAX_FRAME_LENGTH_MS = SUB_FRAME_LENGTH_MS * MAX_NB_SUBFR
MAX_FRAME_LENGTH = MAX_FRAME_LENGTH_MS * 16
LTP_MEM_LENGTH_MS = 20
LTP_ORDER = 5
DECISION_DELAY = 40
TYPE_NO_VOICE_ACTIVITY = 0
TYPE_UNVOICED = 1
TYPE_VOICED = 2
CODE_INDEPENDENTLY = 0
CODE_INDEPENDENTLY_NO_LTP_SCALING = 1
CODE_CONDITIONALLY = 2
MAX_LPC_STABILIZE_ITERATIONS = 16
NLSF_QUANT_MAX_AMPLITUDE = 4
PITCH_EST_MIN_LAG_MS = 2
PITCH_EST_MAX_LAG_MS = 18
CNG_BUF_MASK_MAX = 255
RAND_MULTIPLIER = 196314165
RAND_INCREMENT = 907633515
NLSF_VQ_MAX_VECTORS = 32
MAX_API_FS_KHZ = 48


@dataclass
class SideInfoIndices:
    gains_indices: list = field(default_factory=lambda: [0] * MAX_NB_SUBFR)
    ltp_index: list = field(default_factory=lambda: [0] * MAX_NB_SUBFR)
    nlsf_indices: list = field(default_factory=lambda: [0] * (MAX_LPC_ORDER + 1))
    lag_index: int = 0
    contour_index: int = 0
    signal_type: int = 0
    quant_offset_type: int = 0
    nlsf_interp_coef_q2: int = 0
    per_index: int = 0
    ltp_scale_index: int = 0
    seed: int = 0


@dataclass
class CngState:
    cng_exc_buf_q14: list = field(default_factory=lambda: [0] * MAX_FRAME_LENGTH)
    cng_smth_nlsf_q15: list = field(default_factory=lambda: [0] * MAX_LPC_ORDER)
    cng_synth_state: list = field(default_factory=lambda: [0] * MAX_LPC_ORDER)
    cng_smth_gain_q16: int = 0
    rand_seed: int = 3176576
    fs_khz: int = 0


@dataclass
class PlcState:
    pitch_l_q8: int = 0
    ltp_coef_q14: list = field(default_factory=lambda: [0] * LTP_ORDER)
    prev_lpc_q12: list = field(default_factory=lambda: [0] * MAX_LPC_ORDER)
    last_frame_lost: int = 0
    # NB: the whole struct is zeroed by silk_init_decoder; only CNG gets the
    # 3176576 seed. PLC's starts at 0.
    rand_seed: int = 0
    rand_scale_q14: int = 0
    conc_energy: int = 0
    conc_energy_shift: int = 0
    prev_lt_gain_q18: int = 0
    prev_gain_q16: list = field(default_factory=lambda: [1 << 16, 1 << 16])
    fs_khz: int = 0
    nb_subfr: int = 0
    subfr_length: int = 0
    enable_deep_plc: int = 0


@dataclass
class StereoDecState:
    pred_prev_q13: list = field(default_factory=lambda: [0, 0])
    s_mid: list = field(default_factory=lambda: [0, 0])
    s_side: list = field(default_factory=lambda: [0, 0])


@dataclass
class ResamplerState:
    s_iir: list = field(default_factory=lambda: [0] * 6)
    s_fir: list = field(default_factory=lambda: [0] * 36)
    delay_buf: list = field(default_factory=lambda: [0] * 48)
    resampler_function: int = 0  # 0=copy, 1=private_up, 2=private_down_fir, 3=private_iir_fir
    batch_size: int = 0
    inv_ratio_q16: int = 0
    fir_order: int = 0
    fir_fracs: int = 0
    fs_in_khz: int = 0
    fs_out_khz: int = 0
    input_delay: int = 0
    coefs: list = field(default_factory=list)


@dataclass
class ChannelDecoderState:
    prev_gain_q16: int = 65536
    exc_q14: list = field(default_factory=lambda: [0] * MAX_FRAME_LENGTH)
    s_lpc_q14_buf: list = field(default_factory=lambda: [0] * MAX_LPC_ORDER)
    out_buf: list = field(default_factory=lambda: [0] * (MAX_FRAME_LENGTH + 2 * (LTP_MEM_LENGTH_MS * 16)))
    lag_prev: int = 0
    last_gain_index: int = 0
    fs_khz: int = 0
    fs_api_hz: int = 0
    nb_subfr: int = 0
    frame_length: int = 0
    subfr_length: int = 0
    ltp_mem_length: int = 0
    lpc_order: int = 0
    prev_nlsf_q15: list = field(default_factory=lambda: [0] * MAX_LPC_ORDER)
    first_frame_after_reset: int = 1
    pitch_lag_low_bits_icdf: list = None
    pitch_contour_icdf: list = None
    nframes_decoded: int = 0
    nframes_per_packet: int = 0
    ec_prev_signal_type: int = 0
    ec_prev_lag_index: int = 0
    vad_flags: list = field(default_factory=lambda: [0] * MAX_FRAMES_PER_PACKET)
    lbrr_flag: int = 0
    lbrr_flags: list = field(default_factory=lambda: [0] * MAX_FRAMES_PER_PACKET)
    resampler_state: ResamplerState = field(default_factory=ResamplerState)
    psnlsf_cb: object = None
    indices: SideInfoIndices = field(default_factory=SideInfoIndices)
    s_cng: CngState = field(default_factory=CngState)
    s_plc: PlcState = field(default_factory=PlcState)
    loss_cnt: int = 0
    prev_signal_type: int = 0


@dataclass
class SilkDecoder:
    channel_state: list = field(default_factory=lambda: [ChannelDecoderState(), ChannelDecoderState()])
    s_stereo: StereoDecState = field(default_factory=StereoDecState)
    n_channels_api: int = 0
    n_channels_internal: int = 0
    prev_decode_only_middle: int = 0


@dataclass
class DecControl:
    n_channels_api: int = 1
    n_channels_internal: int = 1
    api_sample_rate: int = 48000
    internal_sample_rate: int = 16000
    payload_size_ms: int = 20
    prev_pitch_lag: int = 0


class NlsfCodebook:
    """NLSF codebook wrapper (NB/MB order 10, WB order 16)."""

    def __init__(self, n_vectors, order, quant_step_q16, inv_quant_step_q6,
                 cb1_q8, cb1_wght_q9, cb1_icdf, pred_q8, ec_sel, ec_icdf,
                 ec_rates_q5, delta_min_q15):
        self.n_vectors = n_vectors
        self.order = order
        self.quant_step_size_q16 = quant_step_q16
        self.inv_quant_step_size_q6 = inv_quant_step_q6
        self.cb1_nlsf_q8 = cb1_q8
        self.cb1_wght_q9 = cb1_wght_q9
        self.cb1_icdf = cb1_icdf
        self.pred_q8 = pred_q8
        self.ec_sel = ec_sel
        self.ec_icdf = ec_icdf
        self.ec_rates_q5 = ec_rates_q5
        self.delta_min_q15 = delta_min_q15


def _build_codebooks():
    from . import tables as T
    nb_mb = NlsfCodebook(
        n_vectors=32, order=10, quant_step_q16=11796, inv_quant_step_q6=356,
        cb1_q8=T.SILK_NLSF_CB1_NB_MB_Q8, cb1_wght_q9=T.SILK_NLSF_CB1_NB_MB_WGHT_Q9,
        cb1_icdf=T.SILK_NLSF_CB1_ICDF_NB_MB, pred_q8=T.SILK_NLSF_PRED_NB_MB_Q8,
        ec_sel=T.SILK_NLSF_CB2_SELECT_NB_MB, ec_icdf=T.SILK_NLSF_CB2_ICDF_NB_MB,
        ec_rates_q5=T.SILK_NLSF_CB2_BITS_NB_MB_Q5, delta_min_q15=T.SILK_NLSF_DELTA_MIN_NB_MB_Q15)
    wb = NlsfCodebook(
        n_vectors=32, order=16, quant_step_q16=9830, inv_quant_step_q6=427,
        cb1_q8=T.SILK_NLSF_CB1_WB_Q8, cb1_wght_q9=T.SILK_NLSF_CB1_WB_WGHT_Q9,
        cb1_icdf=T.SILK_NLSF_CB1_ICDF_WB, pred_q8=T.SILK_NLSF_PRED_WB_Q8,
        ec_sel=T.SILK_NLSF_CB2_SELECT_WB, ec_icdf=T.SILK_NLSF_CB2_ICDF_WB,
        ec_rates_q5=T.SILK_NLSF_CB2_BITS_WB_Q5, delta_min_q15=T.SILK_NLSF_DELTA_MIN_WB_Q15)
    return nb_mb, wb


NLSF_CB_NB_MB, NLSF_CB_WB = _build_codebooks()
