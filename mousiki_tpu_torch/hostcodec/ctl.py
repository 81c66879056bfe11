"""libopus-style ctl surface for the encoder and decoder.

Mirrors OpusDecoderCtlRequest (reference src/opus_decoder.rs:314) and
OpusEncoderCtlRequest (src/opus_encoder.rs:700) with the standard numeric
request IDs, dispatching onto the Python codec objects. Getters return the
value; setters return None. Unknown requests raise ValueError.
"""

from __future__ import annotations

# -- request ids (opus_defines.h numbering) -----------------------------
OPUS_SET_APPLICATION = 4000
OPUS_GET_APPLICATION = 4001
OPUS_SET_BITRATE = 4002
OPUS_GET_BITRATE = 4003
OPUS_SET_MAX_BANDWIDTH = 4004
OPUS_GET_MAX_BANDWIDTH = 4005
OPUS_SET_VBR = 4006
OPUS_GET_VBR = 4007
OPUS_SET_BANDWIDTH = 4008
OPUS_GET_BANDWIDTH = 4009
OPUS_SET_COMPLEXITY = 4010
OPUS_GET_COMPLEXITY = 4011
OPUS_SET_INBAND_FEC = 4012
OPUS_GET_INBAND_FEC = 4013
OPUS_SET_PACKET_LOSS_PERC = 4014
OPUS_GET_PACKET_LOSS_PERC = 4015
OPUS_SET_DTX = 4016
OPUS_GET_DTX = 4017
OPUS_SET_VBR_CONSTRAINT = 4020
OPUS_GET_VBR_CONSTRAINT = 4021
OPUS_SET_FORCE_CHANNELS = 4022
OPUS_GET_FORCE_CHANNELS = 4023
OPUS_SET_SIGNAL = 4024
OPUS_GET_SIGNAL = 4025
OPUS_GET_LOOKAHEAD = 4027
OPUS_RESET_STATE = 4028
OPUS_GET_SAMPLE_RATE = 4029
OPUS_GET_FINAL_RANGE = 4031
OPUS_GET_PITCH = 4033
OPUS_SET_GAIN = 4034
OPUS_GET_GAIN = 4045
OPUS_SET_LSB_DEPTH = 4036
OPUS_GET_LSB_DEPTH = 4037
OPUS_GET_LAST_PACKET_DURATION = 4039
OPUS_SET_EXPERT_FRAME_DURATION = 4040
OPUS_GET_EXPERT_FRAME_DURATION = 4041
OPUS_SET_PREDICTION_DISABLED = 4042
OPUS_GET_PREDICTION_DISABLED = 4043
OPUS_SET_PHASE_INVERSION_DISABLED = 4046
OPUS_GET_PHASE_INVERSION_DISABLED = 4047
OPUS_GET_IN_DTX = 4049
OPUS_SET_DRED_DURATION = 4050
OPUS_GET_DRED_DURATION = 4051
OPUS_SET_FORCE_MODE = 11002

OPUS_AUTO = -1000


def opus_decoder_ctl(dec, request: int, value=None):
    """Dispatch a decoder ctl; see OpusDecoderCtlRequest for the surface."""
    from .bitstream.packet import Bandwidth

    if request == OPUS_SET_GAIN:
        if not -32768 <= value <= 32767:
            raise ValueError("gain out of range")
        dec.decode_gain = value
        return None
    if request == OPUS_GET_GAIN:
        return dec.decode_gain
    if request == OPUS_SET_COMPLEXITY:
        if not 0 <= value <= 10:
            raise ValueError("complexity out of range")
        dec.complexity = value
        return None
    if request == OPUS_GET_COMPLEXITY:
        return getattr(dec, "complexity", 0)
    if request == OPUS_GET_BANDWIDTH:
        bw = dec.bandwidth
        return int(bw) if bw else 0
    if request == OPUS_GET_SAMPLE_RATE:
        return dec.fs
    if request == OPUS_GET_PITCH:
        # voiced SILK: last pitch lag (scaled to the API rate);
        # CELT: postfilter period; else 0
        cs = dec.silk.channel_state[0]
        if cs.lag_prev and cs.fs_khz:
            return cs.lag_prev * dec.fs // (cs.fs_khz * 1000)
        pf = getattr(dec.celt, "postfilter_period", 0)
        return pf if pf > 15 else 0
    if request == OPUS_GET_FINAL_RANGE:
        return dec.final_range
    if request == OPUS_RESET_STATE:
        dec._reset()
        return None
    if request == OPUS_GET_LAST_PACKET_DURATION:
        return getattr(dec, "last_packet_duration", 0)
    if request == OPUS_SET_PHASE_INVERSION_DISABLED:
        dec.phase_inversion_disabled = bool(value)
        dec.celt.disable_inv = bool(value) or dec.stream_channels == 1
        return None
    if request == OPUS_GET_PHASE_INVERSION_DISABLED:
        return getattr(dec, "phase_inversion_disabled", False)
    raise ValueError(f"unknown decoder ctl {request}")


def opus_encoder_ctl(enc, request: int, value=None):
    """Dispatch an encoder ctl; see OpusEncoderCtlRequest for the surface."""
    from .bitstream.packet import Bandwidth, Mode

    simple_attrs = {
        OPUS_SET_APPLICATION: "application", OPUS_GET_APPLICATION: "application",
        OPUS_SET_FORCE_CHANNELS: "force_channels",
        OPUS_GET_FORCE_CHANNELS: "force_channels",
        11018: "voice_ratio", 11019: "voice_ratio",  # voice ratio
        OPUS_SET_PACKET_LOSS_PERC: "packet_loss_perc",
        OPUS_GET_PACKET_LOSS_PERC: "packet_loss_perc",
        OPUS_SET_INBAND_FEC: "inband_fec", OPUS_GET_INBAND_FEC: "inband_fec",
        OPUS_SET_DTX: "dtx", OPUS_GET_DTX: "dtx",
        OPUS_SET_LSB_DEPTH: "lsb_depth", OPUS_GET_LSB_DEPTH: "lsb_depth",
        OPUS_SET_EXPERT_FRAME_DURATION: "expert_frame_duration",
        OPUS_GET_EXPERT_FRAME_DURATION: "expert_frame_duration",
        OPUS_SET_PREDICTION_DISABLED: "prediction_disabled",
        OPUS_GET_PREDICTION_DISABLED: "prediction_disabled",
        OPUS_SET_PHASE_INVERSION_DISABLED: "phase_inversion_disabled",
        OPUS_GET_PHASE_INVERSION_DISABLED: "phase_inversion_disabled",
        OPUS_GET_DRED_DURATION: "_dred_frames",
        OPUS_SET_VBR_CONSTRAINT: "vbr_constraint",
        OPUS_GET_VBR_CONSTRAINT: "vbr_constraint",
        OPUS_SET_SIGNAL: "signal_type_hint", OPUS_GET_SIGNAL: "signal_type_hint",
        OPUS_SET_MAX_BANDWIDTH: "max_bandwidth",
        OPUS_GET_MAX_BANDWIDTH: "max_bandwidth",
    }
    if request == OPUS_SET_DRED_DURATION:
        enc.set_dred_duration(int(value))   # activates the DRED pipeline
        return None
    if request == OPUS_SET_BITRATE:
        enc.set_bitrate(value)
        return None
    if request == OPUS_GET_BITRATE:
        return enc.bitrate
    if request == OPUS_SET_VBR:
        enc.set_vbr(bool(value))
        return None
    if request == OPUS_GET_VBR:
        return enc.vbr
    if request == OPUS_SET_BANDWIDTH:
        enc.set_bandwidth(Bandwidth(value) if not isinstance(value, Bandwidth)
                          else value)
        return None
    if request == OPUS_GET_BANDWIDTH:
        return int(enc.bandwidth)
    if request == OPUS_SET_COMPLEXITY:
        enc.set_complexity(value)
        return None
    if request == OPUS_GET_COMPLEXITY:
        return enc.celt.complexity
    if request == OPUS_GET_LOOKAHEAD:
        return enc.fs // 400 + 120  # frame latency + MDCT overlap
    if request == OPUS_RESET_STATE:
        enc.celt.reset()
        from .silk.encoder import SilkEncoder, SilkStereoEncoder
        enc.silk = SilkEncoder()
        enc.silk_stereo = SilkStereoEncoder()
        return None
    if request == OPUS_GET_SAMPLE_RATE:
        return enc.fs
    if request == OPUS_GET_FINAL_RANGE:
        return enc.final_range
    if request == OPUS_GET_IN_DTX:
        return getattr(enc, "in_dtx", False)
    if request == OPUS_SET_FORCE_MODE:
        if value == OPUS_AUTO:
            enc.force_mode = None
        else:
            enc.force_mode = {1000: Mode.SILK, 1001: Mode.HYBRID,
                              1002: Mode.CELT}[value]
        return None
    if request in simple_attrs:
        # convention: SET request ids are even, GET ids odd
        name = simple_attrs[request]
        if request % 2 == 0:
            setattr(enc, name, value)
            return None
        return getattr(enc, name, 0)
    raise ValueError(f"unknown encoder ctl {request}")
