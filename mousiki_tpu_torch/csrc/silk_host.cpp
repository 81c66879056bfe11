// Native SILK host decoder: range decode -> int16 PCM at the internal rate.
//
// Bit-exact C++ twin of the validated Python host decoder
// (mousiki_tpu/silk/{decode_indices,decode_pulses,decode_params,
// decode_core,fixed_math}.py; reference src/silk/* per SURVEY.md §2.3).
// Covers the clean mono decode path (the loss paths — PLC/CNG — stay in
// Python/device); also exports the dense frame parameters the batched TPU
// synthesis kernel consumes (ops/silk_synthesis_jax.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libsilk_host.so silk_host.cpp

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <cmath>
#include <vector>

#include "silk_tables.h"

namespace {

// ---------------------------------------------------------------- range dec
struct EcDec {
  const uint8_t* buf;
  uint32_t storage;
  uint32_t end_offs;
  uint32_t end_window;
  int nend_bits;
  int nbits_total;
  uint32_t offs;
  uint32_t rng;
  uint32_t val;
  uint32_t ext;
  int rem;
  int error;
};

inline int ec_ilog(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }
inline int ec_read_byte(EcDec* d) {
  return d->offs < d->storage ? d->buf[d->offs++] : 0;
}

void ec_dec_normalize(EcDec* d) {
  while (d->rng <= (1u << 23)) {
    d->nbits_total += 8;
    d->rng <<= 8;
    int sym = d->rem;
    d->rem = ec_read_byte(d);
    sym = ((sym << 8) | d->rem) >> 1;
    d->val = ((d->val << 8) + (255 & ~sym)) & 0x7FFFFFFFu;
  }
}

void ec_dec_init(EcDec* d, const uint8_t* buf, uint32_t storage) {
  memset(d, 0, sizeof(*d));
  d->buf = buf;
  d->storage = storage;
  d->nbits_total = 33 - 24;
  d->rng = 1u << 7;
  d->rem = ec_read_byte(d);
  d->val = d->rng - 1 - (uint32_t)(d->rem >> 1);
  ec_dec_normalize(d);
}

inline int ec_tell(const EcDec* d) { return d->nbits_total - ec_ilog(d->rng); }

int ec_dec_bit_logp(EcDec* d, int logp) {
  uint32_t r = d->rng, dv = d->val, s = r >> logp;
  int ret = dv < s;
  if (!ret) d->val = dv - s;
  d->rng = ret ? s : r - s;
  ec_dec_normalize(d);
  return ret;
}

int ec_dec_icdf(EcDec* d, const uint8_t* icdf, int ftb) {
  uint32_t s = d->rng, dv = d->val, r = s >> ftb, t;
  int ret = -1;
  do {
    t = s;
    s = r * icdf[++ret];
  } while (dv < s);
  d->val = dv - s;
  d->rng = t - s;
  ec_dec_normalize(d);
  return ret;
}

// ---------------------------------------------------------------- fixed math
inline int32_t I32(int64_t x) { return (int32_t)(uint32_t)x; }
inline int16_t I16(int32_t x) { return (int16_t)(uint16_t)x; }
inline int32_t SAT16(int32_t x) {
  return x > 32767 ? 32767 : (x < -32768 ? -32768 : x);
}
inline int32_t SAT32(int64_t x) {
  return x > 0x7FFFFFFFll ? 0x7FFFFFFF
                          : (x < -0x80000000ll ? (int32_t)0x80000000 : (int32_t)x);
}
inline int32_t SMULWB(int32_t a, int32_t b) {
  return I32(((int64_t)a * I16(b)) >> 16);
}
inline int32_t SMLAWB(int32_t a, int32_t b, int32_t c) {
  return I32(a + (((int64_t)b * I16(c)) >> 16));
}
inline int32_t SMULBB(int32_t a, int32_t b) {
  return I32((int32_t)I16(a) * (int32_t)I16(b));
}
inline int32_t SMULWW(int32_t a, int32_t b) {
  return I32(((int64_t)a * b) >> 16);
}
inline int32_t SMLAWW(int32_t a, int32_t b, int32_t c) {
  return I32(a + (((int64_t)b * c) >> 16));
}
inline int32_t SMMUL(int32_t a, int32_t b) {
  return I32(((int64_t)a * b) >> 32);
}
inline int32_t ADD_SAT32(int32_t a, int32_t b) {
  return SAT32((int64_t)a + b);
}
inline int32_t SUB_SAT32(int32_t a, int32_t b) {
  return SAT32((int64_t)a - b);
}
inline int32_t LSHIFT_SAT32(int64_t a, int shift) {
  return SAT32(a << shift);
}
inline int32_t RSHIFT_ROUND(int32_t a, int shift) {
  if (shift == 1) return (a >> 1) + (a & 1);
  return ((a >> (shift - 1)) + 1) >> 1;
}
inline int64_t RSHIFT_ROUND64(int64_t a, int shift) {
  return ((a >> (shift - 1)) + 1) >> 1;
}
inline int CLZ32(int32_t x) {
  return x == 0 ? 32 : __builtin_clz((uint32_t)x);
}
inline int32_t DIV32_16(int32_t a, int32_t b) { return a / b; }
inline int32_t DIV32(int32_t a, int32_t b) { return a / b; }

int32_t silk_div32_varq(int32_t a32, int32_t b32, int qres) {
  int a_headrm = CLZ32(a32 < 0 ? -a32 : a32) - 1;
  int32_t a32_nrm = I32((int64_t)a32 << a_headrm);
  int b_headrm = CLZ32(b32 < 0 ? -b32 : b32) - 1;
  int32_t b32_nrm = I32((int64_t)b32 << b_headrm);
  int32_t b32_inv = DIV32_16(0x7FFFFFFF >> 2, b32_nrm >> 16);
  int32_t result = SMULWB(a32_nrm, b32_inv);
  a32_nrm = I32(a32_nrm - I32((int64_t)SMMUL(b32_nrm, result) << 3));
  result = SMLAWB(result, a32_nrm, b32_inv);
  int lshift = 29 + a_headrm - b_headrm - qres;
  if (lshift < 0) return LSHIFT_SAT32(result, -lshift);
  if (lshift < 32) return result >> lshift;
  return 0;
}

int32_t silk_inverse32_varq(int32_t b32, int qres) {
  int b_headrm = CLZ32(b32 < 0 ? -b32 : b32) - 1;
  int32_t b32_nrm = I32((int64_t)b32 << b_headrm);
  int32_t b32_inv = DIV32_16(0x7FFFFFFF >> 2, b32_nrm >> 16);
  int32_t result = I32((int64_t)b32_inv << 16);
  int32_t err_q32 = I32((int64_t)I32((1 << 29) - SMULWB(b32_nrm, b32_inv)) << 3);
  result = SMLAWW(result, err_q32, b32_inv);
  int lshift = 61 - b_headrm - qres;
  if (lshift <= 0) return LSHIFT_SAT32(result, -lshift);
  if (lshift < 32) return result >> lshift;
  return 0;
}

inline uint32_t ROTR32(uint32_t x, int r) {
  r &= 31;
  return (x >> r) | (x << ((32 - r) & 31));
}

int32_t silk_log2lin(int32_t in_log_q7) {
  if (in_log_q7 < 0) return 0;
  if (in_log_q7 >= 3967) return 0x7FFFFFFF;
  int32_t out = I32(1 << (in_log_q7 >> 7));
  int32_t frac_q7 = in_log_q7 & 0x7F;
  int32_t corr = SMLAWB(frac_q7, SMULBB(frac_q7, 128 - frac_q7), -174);
  if (in_log_q7 < 2048)
    out = I32(out + (((int64_t)out * corr) >> 7));
  else
    out = I32(out + (int64_t)(out >> 7) * corr);
  return out;
}

void silk_bwexpander_32(int32_t* ar, int d, int32_t chirp_q16) {
  int32_t chirp_minus_one_q16 = chirp_q16 - 65536;
  for (int i = 0; i < d - 1; i++) {
    ar[i] = SMULWW(chirp_q16, ar[i]);
    chirp_q16 += (int32_t)RSHIFT_ROUND64(
        (int64_t)chirp_q16 * chirp_minus_one_q16, 16);
  }
  ar[d - 1] = SMULWW(chirp_q16, ar[d - 1]);
}

void silk_bwexpander(int16_t* ar, int d, int32_t chirp_q16) {
  int32_t chirp_minus_one_q16 = chirp_q16 - 65536;
  for (int i = 0; i < d - 1; i++) {
    ar[i] = (int16_t)I16((int32_t)RSHIFT_ROUND64((int64_t)chirp_q16 * ar[i], 16));
    chirp_q16 += (int32_t)RSHIFT_ROUND64((int64_t)chirp_q16 * chirp_minus_one_q16, 16);
  }
  ar[d - 1] = (int16_t)I16((int32_t)RSHIFT_ROUND64((int64_t)chirp_q16 * ar[d - 1], 16));
}

}  // namespace

namespace {

constexpr int MAX_D = 16;
constexpr int LTP_ORDER = 5;
constexpr int MAX_FRAME = 320;
constexpr int MAX_NB_SUBFR = 4;
constexpr int QUANT_LEVEL_ADJUST_Q10 = 80;
constexpr int N_LEVELS_QGAIN = 64;
constexpr int OFFSET_GQ = (2 * 128) / 6 + 16 * 128;
constexpr int INV_SCALE_Q16 = (65536 * (((88 - 2) * 128) / 6)) / (N_LEVELS_QGAIN - 1);
constexpr int NLSF_QUANT_LEVEL_ADJ_Q10 = 102;
constexpr int QA_NLSF = 16;
constexpr int QA_INV = 24;
constexpr int32_t A_LIMIT_Q24 = (int32_t)(0.99975 * (1 << 24) + 0.5);
constexpr int32_t INV_MAX_PRED_GAIN_Q30 = (int32_t)((1.0 / 1e4) * (1 << 30));
constexpr int RAND_MULT = 196314165;
constexpr int RAND_INC = 907633515;

struct SideInfo {
  int gains_indices[4];
  int ltp_index[4];
  int nlsf_indices[MAX_D + 1];
  int lag_index, contour_index;
  int signal_type, quant_offset_type;
  int nlsf_interp_coef_q2;
  int per_index, ltp_scale_index, seed;
};

struct PlcState {
  int32_t pitch_l_q8;
  int16_t ltp_coef_q14[LTP_ORDER];
  int16_t prev_lpc_q12[MAX_D];
  int last_frame_lost;
  int32_t rand_seed;
  int16_t rand_scale_q14;
  int32_t conc_energy;
  int conc_energy_shift;
  int16_t prev_ltp_scale_q14;
  int32_t prev_gain_q16[2];
  int fs_khz;
  int nb_subfr, subfr_length;
};

struct CngState {
  int16_t cng_smth_nlsf_q15[MAX_D];
  int32_t cng_exc_buf_q14[MAX_FRAME];
  int32_t cng_smth_gain_q16;
  int32_t rand_seed;
  int32_t cng_synth_state[MAX_D];
  int fs_khz;
};

struct SilkState {
  uint32_t last_rng;
  int fs_khz, nb_subfr, frame_length, subfr_length, ltp_mem_length, lpc_order;
  int last_gain_index;
  int32_t prev_gain_q16;
  int first_frame_after_reset;
  int ec_prev_signal_type, ec_prev_lag_index;
  int lag_prev;
  int prev_signal_type;
  int nframes_per_packet, nframes_decoded;
  int vad_flags[3], lbrr_flags[3], lbrr_flag;
  int16_t prev_nlsf_q15[MAX_D];
  int32_t s_lpc_q14_buf[MAX_D];
  int16_t out_buf[MAX_FRAME + 2 * 20 * 16];
  int32_t exc_q14[MAX_FRAME];
  SideInfo ix;
  int loss_cnt;
  PlcState plc;
  CngState cng;
};

struct DecCtrl {
  int pitch_l[4];
  int32_t gains_q16[4];
  int16_t pred_coef_q12[2][MAX_D];
  int16_t ltp_coef_q14[4 * LTP_ORDER];
  int ltp_scale_q14;
};

// NLSF codebook view over the generated tables
struct NlsfCb {
  int n_vectors, order, qstep_q16;
  const uint8_t* cb1_nlsf_q8;
  const int16_t* cb1_wght_q9;
  const uint8_t* cb1_icdf;
  const uint8_t* pred_q8;
  const uint8_t* ec_sel;
  const uint8_t* ec_icdf;
  const int16_t* delta_min_q15;
};

NlsfCb nlsf_cb(int wb) {
  if (wb)
    return {kNLSF_WB_NVEC, kNLSF_WB_ORDER, kNLSF_WB_QSTEP_Q16,
            kNLSF_WB_CB1_NLSF_Q8, kNLSF_WB_CB1_WGHT_Q9, kNLSF_WB_CB1_ICDF,
            kNLSF_WB_PRED_Q8, kNLSF_WB_EC_SEL, kNLSF_WB_EC_ICDF,
            kNLSF_WB_DELTA_MIN_Q15};
  return {kNLSF_NBMB_NVEC, kNLSF_NBMB_ORDER, kNLSF_NBMB_QSTEP_Q16,
          kNLSF_NBMB_CB1_NLSF_Q8, kNLSF_NBMB_CB1_WGHT_Q9, kNLSF_NBMB_CB1_ICDF,
          kNLSF_NBMB_PRED_Q8, kNLSF_NBMB_EC_SEL, kNLSF_NBMB_EC_ICDF,
          kNLSF_NBMB_DELTA_MIN_Q15};
}

void nlsf_unpack(const NlsfCb& cb, int ci, int* ec_ix, int* pred_q8) {
  for (int i = 0; i < cb.order / 2; i++) {
    int entry = cb.ec_sel[ci * cb.order / 2 + i];
    ec_ix[2 * i] = ((entry >> 1) & 7) * 9;
    pred_q8[2 * i] = cb.pred_q8[2 * i + (entry & 1) * (cb.order - 1)];
    ec_ix[2 * i + 1] = ((entry >> 5) & 7) * 9;
    pred_q8[2 * i + 1] = cb.pred_q8[2 * i + ((entry >> 4) & 1) * (cb.order - 1) + 1];
  }
}

// ----------------------------------------------------------- decode_indices
void decode_indices(SilkState* st, EcDec* dec, int frame_index,
                    int decode_lbrr, int cond_coding,
                    const uint8_t* contour_icdf, const uint8_t* lag_low_icdf,
                    int lag_low_n) {
  SideInfo& ix = st->ix;
  int val;
  if (decode_lbrr || st->vad_flags[frame_index])
    val = ec_dec_icdf(dec, kSILK_TYPE_OFFSET_VAD_ICDF, 8) + 2;
  else
    val = ec_dec_icdf(dec, kSILK_TYPE_OFFSET_NO_VAD_ICDF, 8);
  ix.signal_type = val >> 1;
  ix.quant_offset_type = val & 1;

  if (cond_coding == 2) {
    ix.gains_indices[0] = ec_dec_icdf(dec, kSILK_DELTA_GAIN_ICDF, 8);
  } else {
    ix.gains_indices[0] = ec_dec_icdf(dec, kSILK_GAIN_ICDF[ix.signal_type], 8)
                          << 3;
    ix.gains_indices[0] += ec_dec_icdf(dec, kSILK_UNIFORM8_ICDF, 8);
  }
  for (int i = 1; i < st->nb_subfr; i++)
    ix.gains_indices[i] = ec_dec_icdf(dec, kSILK_DELTA_GAIN_ICDF, 8);

  NlsfCb cb = nlsf_cb(st->lpc_order == 16);
  int half = (ix.signal_type == 2 ? 1 : 0) * cb.n_vectors;
  ix.nlsf_indices[0] = ec_dec_icdf(dec, cb.cb1_icdf + half, 8);
  int ec_ix[MAX_D], pred_q8[MAX_D];
  nlsf_unpack(cb, ix.nlsf_indices[0], ec_ix, pred_q8);
  for (int i = 0; i < cb.order; i++) {
    int v = ec_dec_icdf(dec, cb.ec_icdf + ec_ix[i], 8);
    if (v == 0)
      v -= ec_dec_icdf(dec, kSILK_NLSF_EXT_ICDF, 8);
    else if (v == 8)
      v += ec_dec_icdf(dec, kSILK_NLSF_EXT_ICDF, 8);
    ix.nlsf_indices[i + 1] = v - 4;
  }

  if (st->nb_subfr == 4)
    ix.nlsf_interp_coef_q2 =
        ec_dec_icdf(dec, kSILK_NLSF_INTERPOLATION_FACTOR_ICDF, 8);
  else
    ix.nlsf_interp_coef_q2 = 4;

  if (ix.signal_type == 2) {
    int decoded = 0, lag_index = 0;
    if (cond_coding == 2 && st->ec_prev_signal_type == 2) {
      int delta = ec_dec_icdf(dec, kPITCH_DELTA_ICDF, 8);
      if (delta > 0) {
        lag_index = st->ec_prev_lag_index + (delta - 9);
        decoded = 1;
      }
    }
    if (!decoded) {
      int high = ec_dec_icdf(dec, kPITCH_LAG_ICDF, 8);
      lag_index = high * (st->fs_khz >> 1)
                  + ec_dec_icdf(dec, lag_low_icdf, 8);
    }
    ix.lag_index = lag_index;
    st->ec_prev_lag_index = lag_index;
    ix.contour_index = ec_dec_icdf(dec, contour_icdf, 8);
    ix.per_index = ec_dec_icdf(dec, kSILK_LTP_PER_INDEX_ICDF, 8);
    const uint8_t* gicdf = ix.per_index == 0 ? kLTP_GAIN_ICDF0
                           : (ix.per_index == 1 ? kLTP_GAIN_ICDF1
                                                : kLTP_GAIN_ICDF2);
    for (int k = 0; k < st->nb_subfr; k++)
      ix.ltp_index[k] = ec_dec_icdf(dec, gicdf, 8);
    if (cond_coding == 0)
      ix.ltp_scale_index = ec_dec_icdf(dec, kSILK_LTPSCALE_ICDF, 8);
    else
      ix.ltp_scale_index = 0;
  }
  st->ec_prev_signal_type = ix.signal_type;
  ix.seed = ec_dec_icdf(dec, kSILK_UNIFORM4_ICDF, 8);
}

// ------------------------------------------------------------ decode_pulses
const uint8_t* shell_table(int lvl) {
  switch (lvl) {
    case 0: return kSILK_SHELL_CODE_TABLE0;
    case 1: return kSILK_SHELL_CODE_TABLE1;
    case 2: return kSILK_SHELL_CODE_TABLE2;
    default: return kSILK_SHELL_CODE_TABLE3;
  }
}

void dec_split(EcDec* dec, int p, const uint8_t* tbl, int* c1, int* c2) {
  if (p > 0) {
    int off = kSILK_SHELL_CODE_TABLE_OFFSETS[p];
    *c1 = ec_dec_icdf(dec, tbl + off, 8);
    *c2 = p - *c1;
  } else {
    *c1 = *c2 = 0;
  }
}

void shell_decoder(EcDec* dec, int pulses4, int* out) {
  const uint8_t *t0 = shell_table(0), *t1 = shell_table(1),
                *t2 = shell_table(2), *t3 = shell_table(3);
  int p3[2], p2a[2], p2b[2], p1[2];
  dec_split(dec, pulses4, t3, &p3[0], &p3[1]);
  dec_split(dec, p3[0], t2, &p2a[0], &p2a[1]);
  dec_split(dec, p2a[0], t1, &p1[0], &p1[1]);
  dec_split(dec, p1[0], t0, &out[0], &out[1]);
  dec_split(dec, p1[1], t0, &out[2], &out[3]);
  dec_split(dec, p2a[1], t1, &p1[0], &p1[1]);
  dec_split(dec, p1[0], t0, &out[4], &out[5]);
  dec_split(dec, p1[1], t0, &out[6], &out[7]);
  dec_split(dec, p3[1], t2, &p2b[0], &p2b[1]);
  dec_split(dec, p2b[0], t1, &p1[0], &p1[1]);
  dec_split(dec, p1[0], t0, &out[8], &out[9]);
  dec_split(dec, p1[1], t0, &out[10], &out[11]);
  dec_split(dec, p2b[1], t1, &p1[0], &p1[1]);
  dec_split(dec, p1[0], t0, &out[12], &out[13]);
  dec_split(dec, p1[1], t0, &out[14], &out[15]);
}

void decode_pulses(EcDec* dec, int signal_type, int quant_offset_type,
                   int frame_length, int* pulses) {
  int rate_level = ec_dec_icdf(dec, kSILK_RATE_LEVELS_ICDF[signal_type >> 1], 8);
  int n_blocks = frame_length >> 4;
  if (n_blocks * 16 < frame_length) n_blocks++;

  int sum_pulses[20] = {0}, n_lshifts[20] = {0};
  for (int i = 0; i < n_blocks; i++) {
    sum_pulses[i] = ec_dec_icdf(dec, kSILK_PULSES_PER_BLOCK_ICDF[rate_level], 8);
    while (sum_pulses[i] == 17) {
      n_lshifts[i]++;
      const uint8_t* tbl = kSILK_PULSES_PER_BLOCK_ICDF[9];
      sum_pulses[i] = n_lshifts[i] == 10 ? ec_dec_icdf(dec, tbl + 1, 8)
                                         : ec_dec_icdf(dec, tbl, 8);
    }
  }
  for (int i = 0; i < n_blocks * 16; i++) pulses[i] = 0;
  for (int i = 0; i < n_blocks; i++)
    if (sum_pulses[i] > 0) shell_decoder(dec, sum_pulses[i], pulses + i * 16);

  for (int i = 0; i < n_blocks; i++) {
    if (n_lshifts[i] > 0) {
      int nls = n_lshifts[i];
      for (int k = 0; k < 16; k++) {
        int q = pulses[i * 16 + k];
        for (int s = 0; s < nls; s++)
          q = (q << 1) + ec_dec_icdf(dec, kSILK_LSB_ICDF, 8);
        pulses[i * 16 + k] = q;
      }
      sum_pulses[i] |= nls << 5;
    }
  }
  // signs
  int base = 7 * (quant_offset_type + (signal_type << 1));
  for (int i = 0; i < n_blocks; i++) {
    if (sum_pulses[i] > 0) {
      uint8_t icdf[2] = {kSILK_SIGN_ICDF[base + std::min(sum_pulses[i] & 0x1F, 6)], 0};
      for (int j = 0; j < 16; j++)
        if (pulses[i * 16 + j] > 0)
          pulses[i * 16 + j] *= 2 * ec_dec_icdf(dec, icdf, 8) - 1;
    }
  }
}

}  // namespace

namespace {

// ------------------------------------------------------------ decode_params
void gains_dequant(const int* idx, int* prev_ind, int conditional,
                   int nb_subfr, int32_t* gains_q16) {
  for (int k = 0; k < nb_subfr; k++) {
    if (k == 0 && !conditional) {
      *prev_ind = std::max(idx[k], *prev_ind - 16);
    } else {
      int ind_tmp = idx[k] + kMIN_DELTA_GAIN_QUANT;
      int double_step = 2 * kMAX_DELTA_GAIN_QUANT - N_LEVELS_QGAIN + *prev_ind;
      if (ind_tmp > double_step)
        *prev_ind += (ind_tmp << 1) - double_step;
      else
        *prev_ind += ind_tmp;
    }
    *prev_ind = std::max(0, std::min(N_LEVELS_QGAIN - 1, *prev_ind));
    gains_q16[k] = silk_log2lin(
        std::min(SMULWB(INV_SCALE_Q16, *prev_ind) + OFFSET_GQ, 3967));
  }
}

void nlsf_residual_dequant(const int* indices, const int* pred_q8,
                           int qstep_q16, int order, int* out) {
  int out_q10 = 0;
  for (int i = order - 1; i >= 0; i--) {
    int pred_q10 = SMULBB(out_q10, pred_q8[i]) >> 8;
    out_q10 = I16(indices[i] << 10);
    if (out_q10 > 0)
      out_q10 = I16(out_q10 - NLSF_QUANT_LEVEL_ADJ_Q10);
    else if (out_q10 < 0)
      out_q10 = I16(out_q10 + NLSF_QUANT_LEVEL_ADJ_Q10);
    out_q10 = SMLAWB(pred_q10, out_q10, qstep_q16);
    out[i] = out_q10;
  }
}

void nlsf_stabilize(int16_t* nlsf, const int16_t* dmin, int L) {
  for (int loop = 0; loop < 20; loop++) {
    int min_diff = nlsf[0] - dmin[0];
    int I = 0;
    for (int i = 1; i < L; i++) {
      int diff = nlsf[i] - (nlsf[i - 1] + dmin[i]);
      if (diff < min_diff) { min_diff = diff; I = i; }
    }
    int diff = (1 << 15) - (nlsf[L - 1] + dmin[L]);
    if (diff < min_diff) { min_diff = diff; I = L; }
    if (min_diff >= 0) return;
    if (I == 0) {
      nlsf[0] = dmin[0];
    } else if (I == L) {
      nlsf[L - 1] = (1 << 15) - dmin[L];
    } else {
      int min_center = dmin[I] >> 1;
      for (int k = 0; k < I; k++) min_center += dmin[k];
      int max_center = (1 << 15) - (dmin[I] >> 1);
      for (int k = L; k > I; k--) max_center -= dmin[k];
      int center = RSHIFT_ROUND(nlsf[I - 1] + nlsf[I], 1);
      center = std::max(min_center, std::min(max_center, center));
      nlsf[I - 1] = (int16_t)(center - (dmin[I] >> 1));
      nlsf[I] = (int16_t)(nlsf[I - 1] + dmin[I]);
    }
  }
  // fallback: sort + clamp
  std::sort(nlsf, nlsf + L);
  nlsf[0] = std::max(nlsf[0], dmin[0]);
  for (int i = 1; i < L; i++)
    nlsf[i] = std::max(nlsf[i],
                       (int16_t)std::min(32767, nlsf[i - 1] + dmin[i]));
  nlsf[L - 1] = std::min(nlsf[L - 1], (int16_t)((1 << 15) - dmin[L]));
  for (int i = L - 2; i >= 0; i--)
    nlsf[i] = std::min(nlsf[i], (int16_t)(nlsf[i + 1] - dmin[i + 1]));
}

void nlsf_decode(const int* indices, const NlsfCb& cb, int16_t* nlsf_q15) {
  int ec_ix[MAX_D], pred_q8[MAX_D];
  nlsf_unpack(cb, indices[0], ec_ix, pred_q8);
  int res_q10[MAX_D];
  nlsf_residual_dequant(indices + 1, pred_q8, cb.qstep_q16, cb.order, res_q10);
  int base = indices[0] * cb.order;
  for (int i = 0; i < cb.order; i++) {
    int w = cb.cb1_wght_q9[base + i];
    int v = DIV32_16(I32((int64_t)res_q10[i] << 14), w)
            + ((int)cb.cb1_nlsf_q8[base + i] << 7);
    nlsf_q15[i] = (int16_t)std::max(0, std::min(32767, v));
  }
  nlsf_stabilize(nlsf_q15, cb.delta_min_q15, cb.order);
}

static const int kOrdering16[16] = {0, 15, 8, 7, 4, 11, 12, 3,
                                    2, 13, 10, 5, 6, 9, 14, 1};
static const int kOrdering10[10] = {0, 9, 6, 3, 4, 5, 8, 1, 2, 7};

void nlsf2a_find_poly(const int32_t* clsf, int dd, int stride, int32_t* out) {
  out[0] = 1 << QA_NLSF;
  out[1] = -clsf[0];
  for (int k = 1; k < dd; k++) {
    int64_t ftmp = clsf[k * stride];
    out[k + 1] = I32(((int64_t)out[k - 1] << 1)
                     - (int32_t)RSHIFT_ROUND64(ftmp * out[k], QA_NLSF));
    for (int n = k; n > 1; n--)
      out[n] = I32((int64_t)out[n] + out[n - 2]
                   - (int32_t)RSHIFT_ROUND64(ftmp * out[n - 1], QA_NLSF));
    out[1] = I32(out[1] - (int32_t)ftmp);
  }
}

void lpc_fit(int32_t* a_qin, int qout, int qin, int d, int16_t* a_qout) {
  int it;
  for (it = 0; it < 10; it++) {
    int32_t maxabs = 0;
    int idx = 0;
    for (int k = 0; k < d; k++) {
      int32_t v = a_qin[k] < 0 ? -a_qin[k] : a_qin[k];
      if (v > maxabs) { maxabs = v; idx = k; }
    }
    maxabs = RSHIFT_ROUND(maxabs, qin - qout);
    if (maxabs > 32767) {
      maxabs = std::min(maxabs, (int32_t)163838);
      int32_t chirp_q16 = (int32_t)(0.999 * 65536)
          - DIV32(I32((int64_t)(maxabs - 32767) << 14),
                  ((int64_t)maxabs * (idx + 1)) >> 2);
      silk_bwexpander_32(a_qin, d, chirp_q16);
    } else {
      break;
    }
  }
  if (it == 10) {
    for (int k = 0; k < d; k++) {
      a_qout[k] = (int16_t)SAT16(RSHIFT_ROUND(a_qin[k], qin - qout));
      a_qin[k] = I32((int64_t)a_qout[k] << (qin - qout));
    }
  } else {
    for (int k = 0; k < d; k++)
      a_qout[k] = (int16_t)I16(RSHIFT_ROUND(a_qin[k], qin - qout));
  }
}

inline int32_t mul32_frac_q(int32_t a, int32_t b, int q) {
  return I32(RSHIFT_ROUND64((int64_t)a * b, q));
}

int32_t lpc_inverse_pred_gain(const int16_t* a_q12, int order) {
  int64_t a_qa[MAX_D];
  int32_t dc_resp = 0;
  for (int k = 0; k < order; k++) {
    dc_resp += a_q12[k];
    a_qa[k] = I32((int32_t)a_q12[k] << (QA_INV - 12));
  }
  if (dc_resp >= 4096) return 0;
  int32_t inv_gain_q30 = 1 << 30;
  for (int k = order - 1; k > 0; k--) {
    if (a_qa[k] > A_LIMIT_Q24 || a_qa[k] < -A_LIMIT_Q24) return 0;
    int32_t rc_q31 = I32(-((int64_t)a_qa[k] << (31 - QA_INV)));
    int32_t rc_mult1_q30 = I32((1 << 30) - SMMUL(rc_q31, rc_q31));
    inv_gain_q30 = I32((int64_t)SMMUL(inv_gain_q30, rc_mult1_q30) << 2);
    if (inv_gain_q30 < INV_MAX_PRED_GAIN_Q30) return 0;
    int mult2q = 32 - CLZ32(rc_mult1_q30 < 0 ? -rc_mult1_q30 : rc_mult1_q30);
    int32_t rc_mult2 = silk_inverse32_varq(rc_mult1_q30, mult2q + 30);
    for (int n = 0; n < (k + 1) >> 1; n++) {
      int64_t tmp1 = a_qa[n];
      int64_t tmp2 = a_qa[k - n - 1];
      int64_t t64 = RSHIFT_ROUND64(
          (int64_t)SUB_SAT32((int32_t)tmp1,
                             mul32_frac_q((int32_t)tmp2, rc_q31, 31))
          * rc_mult2, mult2q);
      if (t64 > 0x7FFFFFFFll || t64 < -0x80000000ll) return 0;
      a_qa[n] = t64;
      t64 = RSHIFT_ROUND64(
          (int64_t)SUB_SAT32((int32_t)tmp2,
                             mul32_frac_q((int32_t)tmp1, rc_q31, 31))
          * rc_mult2, mult2q);
      if (t64 > 0x7FFFFFFFll || t64 < -0x80000000ll) return 0;
      a_qa[k - n - 1] = t64;
    }
  }
  if (a_qa[0] > A_LIMIT_Q24 || a_qa[0] < -A_LIMIT_Q24) return 0;
  int32_t rc_q31 = I32(-((int64_t)a_qa[0] << (31 - QA_INV)));
  int32_t rc_mult1_q30 = I32((1 << 30) - SMMUL(rc_q31, rc_q31));
  inv_gain_q30 = I32((int64_t)SMMUL(inv_gain_q30, rc_mult1_q30) << 2);
  if (inv_gain_q30 < INV_MAX_PRED_GAIN_Q30) return 0;
  return inv_gain_q30;
}

void nlsf2a(const int16_t* nlsf_q15, int d, int16_t* a_q12) {
  const int* ordering = d == 16 ? kOrdering16 : kOrdering10;
  int32_t clsf[MAX_D];
  for (int k = 0; k < d; k++) {
    int f_int = nlsf_q15[k] >> 8;
    int f_frac = nlsf_q15[k] - (f_int << 8);
    int cos_val = kSILK_LSF_COS_TAB_FIX_Q12[f_int];
    int delta = kSILK_LSF_COS_TAB_FIX_Q12[f_int + 1] - cos_val;
    clsf[ordering[k]] = RSHIFT_ROUND((cos_val << 8) + delta * f_frac,
                                     20 - QA_NLSF);
  }
  int dd = d >> 1;
  int32_t P[MAX_D / 2 + 1], Q[MAX_D / 2 + 1];
  nlsf2a_find_poly(clsf + 0, dd, 2, P);
  nlsf2a_find_poly(clsf + 1, dd, 2, Q);
  int32_t a32_qa1[MAX_D];
  for (int k = 0; k < dd; k++) {
    int32_t ptmp = I32((int64_t)P[k + 1] + P[k]);
    int32_t qtmp = I32((int64_t)Q[k + 1] - Q[k]);
    a32_qa1[k] = I32(-(int64_t)qtmp - ptmp);
    a32_qa1[d - k - 1] = I32((int64_t)qtmp - ptmp);
  }
  lpc_fit(a32_qa1, 12, QA_NLSF + 1, d, a_q12);
  for (int i = 0; i < 20; i++) {
    if (lpc_inverse_pred_gain(a_q12, d) != 0) break;
    silk_bwexpander_32(a32_qa1, d, 65536 - (2 << i));
    for (int k = 0; k < d; k++)
      a_q12[k] = (int16_t)I16(RSHIFT_ROUND(a32_qa1[k], QA_NLSF + 1 - 12));
  }
}

void decode_pitch(int lag_index, int contour_index, int fs_khz, int nb_subfr,
                  int* pitch_l) {
  int min_lag = 2 * fs_khz, max_lag = 18 * fs_khz;
  int lag = min_lag + lag_index;
  for (int k = 0; k < nb_subfr; k++) {
    int off;
    if (fs_khz == 8)
      off = nb_subfr == 4 ? (int)kSILK_CB_LAGS_STAGE2[k][contour_index]
                          : (int)kSILK_CB_LAGS_STAGE2_10_MS[k][contour_index];
    else
      off = nb_subfr == 4 ? (int)kSILK_CB_LAGS_STAGE3[k][contour_index]
                          : (int)kSILK_CB_LAGS_STAGE3_10_MS[k][contour_index];
    pitch_l[k] = std::max(min_lag, std::min(max_lag, lag + off));
  }
}

void decode_parameters(SilkState* st, DecCtrl* ctrl, int cond_coding) {
  SideInfo& ix = st->ix;
  gains_dequant(ix.gains_indices, &st->last_gain_index, cond_coding == 2,
                st->nb_subfr, ctrl->gains_q16);

  NlsfCb cb = nlsf_cb(st->lpc_order == 16);
  int16_t nlsf_q15[MAX_D];
  nlsf_decode(ix.nlsf_indices, cb, nlsf_q15);
  nlsf2a(nlsf_q15, st->lpc_order, ctrl->pred_coef_q12[1]);

  if (st->first_frame_after_reset) ix.nlsf_interp_coef_q2 = 4;
  if (ix.nlsf_interp_coef_q2 < 4) {
    int16_t nlsf0[MAX_D];
    for (int i = 0; i < st->lpc_order; i++)
      nlsf0[i] = (int16_t)(st->prev_nlsf_q15[i]
                           + ((ix.nlsf_interp_coef_q2
                               * (nlsf_q15[i] - st->prev_nlsf_q15[i])) >> 2));
    nlsf2a(nlsf0, st->lpc_order, ctrl->pred_coef_q12[0]);
  } else {
    memcpy(ctrl->pred_coef_q12[0], ctrl->pred_coef_q12[1],
           sizeof(ctrl->pred_coef_q12[0]));
  }
  memcpy(st->prev_nlsf_q15, nlsf_q15, st->lpc_order * sizeof(int16_t));

  if (st->loss_cnt) {
    // first frame after loss: mild LPC bandwidth expansion
    // (decode_params.py:292, BWE_AFTER_LOSS_Q16)
    silk_bwexpander(ctrl->pred_coef_q12[0], st->lpc_order, 63570);
    silk_bwexpander(ctrl->pred_coef_q12[1], st->lpc_order, 63570);
  }

  if (ix.signal_type == 2) {
    decode_pitch(ix.lag_index, ix.contour_index, st->fs_khz, st->nb_subfr,
                 ctrl->pitch_l);
    for (int k = 0; k < st->nb_subfr; k++) {
      const int16_t* cbk = ix.per_index == 0 ? &kLTP_CB0[0][0]
                           : (ix.per_index == 1 ? &kLTP_CB1[0][0]
                                                : &kLTP_CB2[0][0]);
      for (int i = 0; i < LTP_ORDER; i++)
        ctrl->ltp_coef_q14[k * LTP_ORDER + i] =
            (int16_t)((int16_t)cbk[ix.ltp_index[k] * LTP_ORDER + i] << 7);
    }
    ctrl->ltp_scale_q14 = kSILK_LTPSCALES_TABLE_Q14[ix.ltp_scale_index];
  } else {
    memset(ctrl->pitch_l, 0, sizeof(ctrl->pitch_l));
    memset(ctrl->ltp_coef_q14, 0, sizeof(ctrl->ltp_coef_q14));
    ix.per_index = 0;
    ctrl->ltp_scale_q14 = 0;
  }
}

// -------------------------------------------------------------- decode_core
inline int32_t silk_rand(int32_t seed) {
  return I32(RAND_INC + (int64_t)I32((int64_t)seed * RAND_MULT));
}

void lpc_analysis_filter(int16_t* out, const int16_t* inp, int off,
                         const int16_t* B, int length, int d) {
  for (int ix = d; ix < length; ix++) {
    int p = off + ix - 1;
    int32_t out32_q12 = 0;
    for (int j = 0; j < d; j++)
      out32_q12 = I32(out32_q12 + (int32_t)inp[p - j] * B[j]);
    out32_q12 = I32(((int64_t)inp[p + 1] << 12) - out32_q12);
    out[ix] = (int16_t)SAT16(RSHIFT_ROUND(out32_q12, 12));
  }
  for (int ix = 0; ix < d; ix++) out[ix] = 0;
}

void decode_core(SilkState* st, DecCtrl* ctrl, const int* pulses,
                 int16_t* xq) {
  SideInfo& ix = st->ix;
  int offset_q10 = (int)kSILK_QUANTIZATION_OFFSETS_Q10
      [ix.signal_type >> 1][ix.quant_offset_type];
  int nlsf_interp_flag = ix.nlsf_interp_coef_q2 < 4 ? 1 : 0;

  int32_t rand_seed = ix.seed;
  for (int i = 0; i < st->frame_length; i++) {
    rand_seed = silk_rand(rand_seed);
    int32_t v = I32((int64_t)pulses[i] << 14);
    if (v > 0) v -= QUANT_LEVEL_ADJUST_Q10 << 4;
    else if (v < 0) v += QUANT_LEVEL_ADJUST_Q10 << 4;
    v = I32((int64_t)v + (offset_q10 << 4));
    if (rand_seed < 0) v = -v;
    st->exc_q14[i] = v;
    rand_seed = I32((int64_t)rand_seed + pulses[i]);
  }

  int32_t sLPC[MAX_D + MAX_FRAME / 2];
  memcpy(sLPC, st->s_lpc_q14_buf, sizeof(st->s_lpc_q14_buf));
  int16_t sLTP[2 * 20 * 16];
  int32_t sLTP_q15[2 * 20 * 16 + MAX_FRAME];
  memset(sLTP_q15, 0, sizeof(sLTP_q15));
  int sLTP_buf_idx = st->ltp_mem_length;
  int lag = 0;

  for (int k = 0; k < st->nb_subfr; k++) {
    const int16_t* A_q12 = ctrl->pred_coef_q12[k >> 1];
    const int16_t* B_q14 = ctrl->ltp_coef_q14 + k * LTP_ORDER;
    int signal_type = ix.signal_type;

    int32_t gain_q10 = ctrl->gains_q16[k] >> 6;
    int32_t inv_gain_q31 = silk_inverse32_varq(ctrl->gains_q16[k], 47);
    int32_t gain_adj_q16 = 1 << 16;
    if (ctrl->gains_q16[k] != st->prev_gain_q16) {
      gain_adj_q16 = silk_div32_varq(st->prev_gain_q16, ctrl->gains_q16[k], 16);
      for (int i = 0; i < MAX_D; i++)
        sLPC[i] = SMULWW(gain_adj_q16, sLPC[i]);
    }
    st->prev_gain_q16 = ctrl->gains_q16[k];

    // avoid an abrupt voiced-PLC -> unvoiced transition right after loss
    // (decode_core.py:85; only the first two subframes)
    int16_t b_trans[LTP_ORDER];
    if (st->loss_cnt && st->prev_signal_type == 2 && ix.signal_type != 2
        && k < 2) {
      memset(b_trans, 0, sizeof(b_trans));
      b_trans[LTP_ORDER / 2] = 4096;  // 0.25 in Q14
      B_q14 = b_trans;
      signal_type = 2;
      ctrl->pitch_l[k] = st->lag_prev;
    }

    if (signal_type == 2) {
      lag = ctrl->pitch_l[k];
      if (k == 0 || (k == 2 && nlsf_interp_flag)) {
        int start_idx = st->ltp_mem_length - lag - st->lpc_order
                        - LTP_ORDER / 2;
        if (k == 2)
          for (int i = 0; i < 2 * st->subfr_length; i++)
            st->out_buf[st->ltp_mem_length + i] = xq[i];
        lpc_analysis_filter(sLTP + start_idx, st->out_buf,
                            start_idx + k * st->subfr_length, A_q12,
                            st->ltp_mem_length - start_idx, st->lpc_order);
        if (k == 0)
          inv_gain_q31 = I32((int64_t)SMULWB(inv_gain_q31,
                                             ctrl->ltp_scale_q14) << 2);
        for (int i = 0; i < lag + LTP_ORDER / 2; i++)
          sLTP_q15[sLTP_buf_idx - i - 1] =
              SMULWB(inv_gain_q31, sLTP[st->ltp_mem_length - i - 1]);
      } else if (gain_adj_q16 != 1 << 16) {
        for (int i = 0; i < lag + LTP_ORDER / 2; i++)
          sLTP_q15[sLTP_buf_idx - i - 1] =
              SMULWW(gain_adj_q16, sLTP_q15[sLTP_buf_idx - i - 1]);
      }
    }

    int32_t* res_q14;
    int32_t res_buf[MAX_FRAME / 2];
    if (signal_type == 2) {
      int pl = sLTP_buf_idx - lag + LTP_ORDER / 2;
      for (int i = 0; i < st->subfr_length; i++) {
        int32_t p = 2;
        p = SMLAWB(p, sLTP_q15[pl + 0], B_q14[0]);
        p = SMLAWB(p, sLTP_q15[pl - 1], B_q14[1]);
        p = SMLAWB(p, sLTP_q15[pl - 2], B_q14[2]);
        p = SMLAWB(p, sLTP_q15[pl - 3], B_q14[3]);
        p = SMLAWB(p, sLTP_q15[pl - 4], B_q14[4]);
        pl++;
        res_buf[i] = I32((int64_t)st->exc_q14[k * st->subfr_length + i]
                         + I32((int64_t)p << 1));
        sLTP_q15[sLTP_buf_idx] = I32((int64_t)res_buf[i] << 1);
        sLTP_buf_idx++;
      }
      res_q14 = res_buf;
    } else {
      res_q14 = st->exc_q14 + k * st->subfr_length;
    }

    for (int i = 0; i < st->subfr_length; i++) {
      int32_t lpc_pred_q10 = st->lpc_order >> 1;
      for (int j = 0; j < st->lpc_order; j++)
        lpc_pred_q10 = SMLAWB(lpc_pred_q10, sLPC[MAX_D + i - 1 - j], A_q12[j]);
      sLPC[MAX_D + i] = ADD_SAT32(res_q14[i],
                                  LSHIFT_SAT32((int64_t)lpc_pred_q10, 4));
      xq[k * st->subfr_length + i] =
          (int16_t)SAT16(RSHIFT_ROUND(SMULWW(sLPC[MAX_D + i], gain_q10), 8));
    }
    memmove(sLPC, sLPC + st->subfr_length, MAX_D * sizeof(int32_t));
  }
  memcpy(st->s_lpc_q14_buf, sLPC, sizeof(st->s_lpc_q14_buf));
}

}  // namespace

namespace {

void state_set_fs(SilkState* st, int fs_khz, int nb_subfr) {
  st->nb_subfr = nb_subfr;
  st->subfr_length = 5 * fs_khz;
  int frame_length = nb_subfr * st->subfr_length;
  if (st->fs_khz != fs_khz || frame_length != st->frame_length) {
    if (st->fs_khz != fs_khz) {
      st->ltp_mem_length = 20 * fs_khz;
      st->lpc_order = (fs_khz == 16) ? 16 : 10;
      st->first_frame_after_reset = 1;
      st->lag_prev = 100;
      st->last_gain_index = 10;
      st->prev_signal_type = 0;
      memset(st->out_buf, 0, sizeof(st->out_buf));
      memset(st->s_lpc_q14_buf, 0, sizeof(st->s_lpc_q14_buf));
    }
    st->fs_khz = fs_khz;
    st->frame_length = frame_length;
  }
}

// -------------------------------------------------------------- PLC / CNG
// Int-exact twins of mousiki_tpu/silk/plc.py + cng.py (reference
// src/silk/plc.rs, cng.rs; libopus silk/PLC.c, CNG.c).
constexpr int NB_ATT = 2;
constexpr int16_t kHarmAttQ15[NB_ATT] = {32440, 31130};
constexpr int16_t kRandAttVQ15[NB_ATT] = {31130, 26214};
constexpr int16_t kRandAttUVQ15[NB_ATT] = {32440, 29491};
constexpr int V_PITCH_GAIN_START_MIN_Q14 = 11469;
constexpr int V_PITCH_GAIN_START_MAX_Q14 = 15565;
constexpr int32_t BWE_COEF_Q16 = 64881;
constexpr int32_t PITCH_DRIFT_FAC_Q16 = 655;
constexpr int RAND_BUF_SIZE = 128;
constexpr int RAND_BUF_MASK = RAND_BUF_SIZE - 1;
constexpr int LOG2_INV_LPC_GAIN_HIGH_THRES = 3;
constexpr int LOG2_INV_LPC_GAIN_LOW_THRES = 8;
constexpr int32_t CNG_NLSF_SMTH_Q16 = 16348;
constexpr int32_t CNG_GAIN_SMTH_Q16 = 4634;

inline void CLZ_FRAC(int32_t x, int* lz, int* frac_q7) {
  *lz = CLZ32(x);
  *frac_q7 = x == 0 ? 0 : (int)(ROTR32((uint32_t)x, 24 - *lz) & 0x7F);
}

int32_t SQRT_APPROX(int32_t x) {
  if (x <= 0) return 0;
  int lz, frac_q7;
  CLZ_FRAC(x, &lz, &frac_q7);
  int32_t y = (lz & 1) ? 32768 : 46214;
  y >>= lz >> 1;
  y = SMLAWB(y, y, SMULBB(213, frac_q7));
  return y;
}

void sum_sqr_shift(const int16_t* x, int length, int32_t* energy,
                   int* shift) {
  int shft = 31 - CLZ32(length);
  int32_t nrg = length;
  int i = 0;
  for (; i < length - 1; i += 2) {
    int32_t t = I32((int64_t)x[i] * x[i] + (int64_t)x[i + 1] * x[i + 1]);
    nrg = I32(nrg + ((uint32_t)t >> shft));
  }
  if (i < length) nrg = I32(nrg + (((int32_t)x[i] * x[i]) >> shft));
  shft = shft + 3 - CLZ32(nrg);
  if (shft < 0) shft = 0;
  nrg = 0;
  for (i = 0; i < length - 1; i += 2) {
    int32_t t = I32((int64_t)x[i] * x[i] + (int64_t)x[i + 1] * x[i + 1]);
    nrg = I32(nrg + ((uint32_t)t >> shft));
  }
  if (i < length) nrg = I32(nrg + (((int32_t)x[i] * x[i]) >> shft));
  *energy = nrg;
  *shift = shft;
}

void plc_reset(SilkState* st) {
  st->plc.pitch_l_q8 = st->frame_length << 7;
  st->plc.prev_gain_q16[0] = 1 << 16;
  st->plc.prev_gain_q16[1] = 1 << 16;
  st->plc.subfr_length = 20;
  st->plc.nb_subfr = 2;
}

void plc_update(SilkState* st, const DecCtrl* ctrl) {
  PlcState* plc = &st->plc;
  st->prev_signal_type = st->ix.signal_type;
  int32_t ltp_gain_q14 = 0;
  if (st->ix.signal_type == 2) {
    for (int j = 0; j * st->subfr_length < ctrl->pitch_l[st->nb_subfr - 1];
         j++) {
      if (j == st->nb_subfr) break;
      int32_t temp = 0;
      for (int t = 0; t < LTP_ORDER; t++)
        temp += ctrl->ltp_coef_q14[(st->nb_subfr - 1 - j) * LTP_ORDER + t];
      if (temp > ltp_gain_q14) {
        ltp_gain_q14 = temp;
        memcpy(plc->ltp_coef_q14,
               ctrl->ltp_coef_q14 + (st->nb_subfr - 1 - j) * LTP_ORDER,
               LTP_ORDER * sizeof(int16_t));
        plc->pitch_l_q8 = ctrl->pitch_l[st->nb_subfr - 1 - j] << 8;
      }
    }
    memset(plc->ltp_coef_q14, 0, sizeof(plc->ltp_coef_q14));
    plc->ltp_coef_q14[LTP_ORDER / 2] = (int16_t)ltp_gain_q14;
    if (ltp_gain_q14 < V_PITCH_GAIN_START_MIN_Q14) {
      int32_t scale_q10 = DIV32(V_PITCH_GAIN_START_MIN_Q14 << 10,
                                ltp_gain_q14 > 1 ? ltp_gain_q14 : 1);
      for (int i = 0; i < LTP_ORDER; i++)
        plc->ltp_coef_q14[i] =
            (int16_t)(SMULBB(plc->ltp_coef_q14[i], scale_q10) >> 10);
    } else if (ltp_gain_q14 > V_PITCH_GAIN_START_MAX_Q14) {
      int32_t scale_q14 = DIV32(V_PITCH_GAIN_START_MAX_Q14 << 14,
                                ltp_gain_q14 > 1 ? ltp_gain_q14 : 1);
      for (int i = 0; i < LTP_ORDER; i++)
        plc->ltp_coef_q14[i] =
            (int16_t)(SMULBB(plc->ltp_coef_q14[i], scale_q14) >> 14);
    }
  } else {
    plc->pitch_l_q8 = (st->fs_khz * 18) << 8;
    memset(plc->ltp_coef_q14, 0, sizeof(plc->ltp_coef_q14));
  }
  memset(plc->prev_lpc_q12, 0, sizeof(plc->prev_lpc_q12));
  memcpy(plc->prev_lpc_q12, ctrl->pred_coef_q12[1],
         st->lpc_order * sizeof(int16_t));
  plc->prev_ltp_scale_q14 = (int16_t)ctrl->ltp_scale_q14;
  plc->prev_gain_q16[0] = ctrl->gains_q16[st->nb_subfr - 2];
  plc->prev_gain_q16[1] = ctrl->gains_q16[st->nb_subfr - 1];
  plc->subfr_length = st->subfr_length;
  plc->nb_subfr = st->nb_subfr;
}

void plc_conceal(SilkState* st, DecCtrl* ctrl, int16_t* frame) {
  PlcState* plc = &st->plc;
  int32_t prev_gain_q10[2] = {plc->prev_gain_q16[0] >> 6,
                              plc->prev_gain_q16[1] >> 6};
  if (st->first_frame_after_reset)
    memset(plc->prev_lpc_q12, 0, sizeof(plc->prev_lpc_q12));

  // lowest-energy of the last two subframes picks the random source
  int16_t exc_buf[2 * 5 * 16];
  int idx2 = 0;
  for (int k = 0; k < 2; k++) {
    int base = (k + st->nb_subfr - 2) * st->subfr_length;
    for (int i = 0; i < st->subfr_length; i++)
      exc_buf[idx2++] = (int16_t)SAT16(
          SMULWW(st->exc_q14[base + i], prev_gain_q10[k]) >> 8);
  }
  int32_t energy1, energy2;
  int shift1, shift2;
  sum_sqr_shift(exc_buf, st->subfr_length, &energy1, &shift1);
  sum_sqr_shift(exc_buf + st->subfr_length, st->subfr_length, &energy2,
                &shift2);
  int rand_base;
  if ((energy1 >> shift2) < (energy2 >> shift1))
    rand_base = (plc->nb_subfr - 1) * plc->subfr_length - RAND_BUF_SIZE;
  else
    rand_base = plc->nb_subfr * plc->subfr_length - RAND_BUF_SIZE;
  if (rand_base < 0) rand_base = 0;

  int16_t b_q14[LTP_ORDER];
  memcpy(b_q14, plc->ltp_coef_q14, sizeof(b_q14));
  int32_t rand_scale_q14 = plc->rand_scale_q14;

  int att = st->loss_cnt < NB_ATT - 1 ? st->loss_cnt : NB_ATT - 1;
  int32_t harm_gain_q15 = kHarmAttQ15[att];
  int32_t rand_gain_q15 = st->prev_signal_type == 2 ? kRandAttVQ15[att]
                                                    : kRandAttUVQ15[att];

  silk_bwexpander(plc->prev_lpc_q12, st->lpc_order, BWE_COEF_Q16);
  const int16_t* a_q12 = plc->prev_lpc_q12;

  if (st->loss_cnt == 0) {
    rand_scale_q14 = 1 << 14;
    if (st->prev_signal_type == 2) {
      for (int i = 0; i < LTP_ORDER; i++) rand_scale_q14 -= b_q14[i];
      if (rand_scale_q14 < 3277) rand_scale_q14 = 3277;
      rand_scale_q14 =
          (int16_t)(SMULBB(rand_scale_q14, plc->prev_ltp_scale_q14) >> 14);
    } else {
      int32_t inv_gain_q30 = lpc_inverse_pred_gain(a_q12, st->lpc_order);
      int32_t down_scale_q30 = (1 << 30) >> LOG2_INV_LPC_GAIN_HIGH_THRES;
      if (inv_gain_q30 < down_scale_q30) down_scale_q30 = inv_gain_q30;
      int32_t lo = (1 << 30) >> LOG2_INV_LPC_GAIN_LOW_THRES;
      if (down_scale_q30 < lo) down_scale_q30 = lo;
      down_scale_q30 = I32(down_scale_q30 << LOG2_INV_LPC_GAIN_HIGH_THRES);
      rand_gain_q15 = SMULWB(down_scale_q30, rand_gain_q15) >> 14;
    }
  }

  int32_t rand_seed = plc->rand_seed;
  int lag = RSHIFT_ROUND(plc->pitch_l_q8, 8);
  int sltp_buf_idx = st->ltp_mem_length;

  // rewhiten the LTP state with the (expanded) previous LPC
  int idx = st->ltp_mem_length - lag - st->lpc_order - LTP_ORDER / 2;
  if (idx < 1) idx = 1;
  int16_t sltp[2 * 20 * 16];
  lpc_analysis_filter(sltp + idx, st->out_buf, idx, a_q12,
                      st->ltp_mem_length - idx, st->lpc_order);
  int32_t inv_gain_q30 = silk_inverse32_varq(plc->prev_gain_q16[1], 46);
  if (inv_gain_q30 > (0x7FFFFFFF >> 1)) inv_gain_q30 = 0x7FFFFFFF >> 1;
  static thread_local int32_t sltp_q14[2 * 20 * 16 + MAX_FRAME];
  memset(sltp_q14, 0, sizeof(int32_t) * (st->ltp_mem_length
                                         + st->frame_length));
  for (int i = idx + st->lpc_order; i < st->ltp_mem_length; i++)
    sltp_q14[i] = SMULWB(inv_gain_q30, sltp[i]);

  // LTP synthesis over the concealed frame
  for (int k = 0; k < st->nb_subfr; k++) {
    int pl = sltp_buf_idx - lag + LTP_ORDER / 2;
    for (int i = 0; i < st->subfr_length; i++) {
      int32_t ltp_pred_q12 = 2;
      for (int t = 0; t < LTP_ORDER; t++)
        ltp_pred_q12 = SMLAWB(ltp_pred_q12, sltp_q14[pl - t], b_q14[t]);
      pl++;
      rand_seed = silk_rand(rand_seed);
      int ridx = (rand_seed >> 25) & RAND_BUF_MASK;
      sltp_q14[sltp_buf_idx] = I32(
          (int64_t)SMLAWB(ltp_pred_q12, st->exc_q14[rand_base + ridx],
                          rand_scale_q14)
          << 2);
      sltp_buf_idx++;
    }
    for (int j = 0; j < LTP_ORDER; j++)
      b_q14[j] = (int16_t)(SMULBB(harm_gain_q15, b_q14[j]) >> 15);
    if (st->ix.signal_type != 0)
      rand_scale_q14 =
          (int16_t)(SMULBB(rand_scale_q14, rand_gain_q15) >> 15);
    plc->pitch_l_q8 = SMLAWB(plc->pitch_l_q8, plc->pitch_l_q8,
                             PITCH_DRIFT_FAC_Q16);
    int32_t maxq8 = (18 * st->fs_khz) << 8;
    if (plc->pitch_l_q8 > maxq8) plc->pitch_l_q8 = maxq8;
    lag = RSHIFT_ROUND(plc->pitch_l_q8, 8);
  }

  // LPC synthesis over the concealed excitation
  int base = st->ltp_mem_length - MAX_D;
  memcpy(sltp_q14 + base, st->s_lpc_q14_buf, sizeof(st->s_lpc_q14_buf));
  for (int i = 0; i < st->frame_length; i++) {
    int32_t lpc_pred_q10 = st->lpc_order >> 1;
    for (int j = 0; j < st->lpc_order; j++)
      lpc_pred_q10 = SMLAWB(lpc_pred_q10,
                            sltp_q14[base + MAX_D + i - 1 - j], a_q12[j]);
    sltp_q14[base + MAX_D + i] =
        ADD_SAT32(sltp_q14[base + MAX_D + i],
                  LSHIFT_SAT32(lpc_pred_q10, 4));
    frame[i] = (int16_t)SAT16(RSHIFT_ROUND(
        SMULWW(sltp_q14[base + MAX_D + i], prev_gain_q10[1]), 8));
  }
  memcpy(st->s_lpc_q14_buf, sltp_q14 + base + st->frame_length,
         sizeof(st->s_lpc_q14_buf));

  plc->rand_seed = rand_seed;
  plc->rand_scale_q14 = (int16_t)rand_scale_q14;
  for (int i = 0; i < st->nb_subfr && i < 4; i++) ctrl->pitch_l[i] = lag;
}

void plc_glue_frames(SilkState* st, int16_t* frame, int length) {
  PlcState* plc = &st->plc;
#ifdef SILK_PLC_DEBUG
  fprintf(stderr, "glue: loss=%d lastlost=%d conc=%d shift=%d f[0..3]=%d %d %d %d\n",
          st->loss_cnt, plc->last_frame_lost, plc->conc_energy,
          plc->conc_energy_shift, frame[0], frame[1], frame[2], frame[3]);
#endif
  if (st->loss_cnt) {
    sum_sqr_shift(frame, length, &plc->conc_energy,
                  &plc->conc_energy_shift);
    plc->last_frame_lost = 1;
  } else {
    if (plc->last_frame_lost) {
      int32_t energy;
      int energy_shift;
      sum_sqr_shift(frame, length, &energy, &energy_shift);
      if (energy_shift > plc->conc_energy_shift)
        plc->conc_energy >>= energy_shift - plc->conc_energy_shift;
      else if (energy_shift < plc->conc_energy_shift)
        energy >>= plc->conc_energy_shift - energy_shift;
      if (energy > plc->conc_energy) {
        int lz = CLZ32(plc->conc_energy) - 1;
#ifdef SILK_PLC_DEBUG
        fprintf(stderr, "glue RAMP: energy=%d conc=%d lz=%d\n", energy,
                plc->conc_energy, lz);
#endif
        plc->conc_energy = I32((int64_t)plc->conc_energy << lz);
        int sh = 24 - lz;
        if (sh < 0) sh = 0;
        energy >>= sh;
        int32_t frac_q24 = DIV32(plc->conc_energy,
                                 energy > 1 ? energy : 1);
        int32_t gain_q16 = I32((int64_t)SQRT_APPROX(frac_q24) << 4);
        int32_t slope_q16 = I32((int64_t)DIV32_16((1 << 16) - gain_q16,
                                                  length)
                                << 2);
        for (int i = 0; i < length; i++) {
          frame[i] = (int16_t)I16(SMULWB(gain_q16, frame[i]));
          gain_q16 += slope_q16;
          if (gain_q16 > 1 << 16) break;
        }
      }
    }
    plc->last_frame_lost = 0;
  }
}

void cng_reset(SilkState* st) {
  int32_t nlsf_step_q15 = DIV32_16(32767, st->lpc_order + 1);
  int32_t acc = 0;
  for (int i = 0; i < st->lpc_order; i++) {
    acc += nlsf_step_q15;
    st->cng.cng_smth_nlsf_q15[i] = (int16_t)acc;
  }
  st->cng.cng_smth_gain_q16 = 0;
  st->cng.rand_seed = 3176576;
}

void silk_cng(SilkState* st, const DecCtrl* ctrl, int16_t* frame,
              int length) {
  CngState* cng = &st->cng;
  if (st->fs_khz != cng->fs_khz) {
    cng_reset(st);
    cng->fs_khz = st->fs_khz;
  }
  if (st->loss_cnt == 0 && st->prev_signal_type == 0) {
    for (int i = 0; i < st->lpc_order; i++)
      cng->cng_smth_nlsf_q15[i] = (int16_t)(cng->cng_smth_nlsf_q15[i]
          + SMULWB(st->prev_nlsf_q15[i] - cng->cng_smth_nlsf_q15[i],
                   CNG_NLSF_SMTH_Q16));
    int32_t max_gain = 0;
    int subfr = 0;
    for (int i = 0; i < st->nb_subfr; i++)
      if (ctrl->gains_q16[i] > max_gain) {
        max_gain = ctrl->gains_q16[i];
        subfr = i;
      }
    memmove(cng->cng_exc_buf_q14 + st->subfr_length, cng->cng_exc_buf_q14,
            (st->nb_subfr - 1) * st->subfr_length * sizeof(int32_t));
    memcpy(cng->cng_exc_buf_q14,
           st->exc_q14 + subfr * st->subfr_length,
           st->subfr_length * sizeof(int32_t));
    for (int i = 0; i < st->nb_subfr; i++)
      cng->cng_smth_gain_q16 += SMULWB(
          ctrl->gains_q16[i] - cng->cng_smth_gain_q16, CNG_GAIN_SMTH_Q16);
  }
  if (st->loss_cnt) {
    int32_t gain_q16 = SMULWW(st->plc.rand_scale_q14,
                              st->plc.prev_gain_q16[1]);
    if (gain_q16 >= (1 << 21) || cng->cng_smth_gain_q16 > (1 << 23)) {
      gain_q16 = (gain_q16 >> 16) * (gain_q16 >> 16);
      gain_q16 = I32((cng->cng_smth_gain_q16 >> 16)
                     * (int64_t)(cng->cng_smth_gain_q16 >> 16)
                     - ((int64_t)gain_q16 << 5));
      gain_q16 = I32((int64_t)SQRT_APPROX(gain_q16) << 16);
    } else {
      gain_q16 = SMULWW(gain_q16, gain_q16);
      gain_q16 = I32(SMULWW(cng->cng_smth_gain_q16, cng->cng_smth_gain_q16)
                     - ((int64_t)gain_q16 << 5));
      gain_q16 = I32((int64_t)SQRT_APPROX(gain_q16) << 8);
    }
    int32_t gain_q10 = gain_q16 >> 6;
    // CNG excitation from the randomized buffer
    int exc_mask = 255;
    while (exc_mask > length) exc_mask >>= 1;
    static thread_local int32_t sig[MAX_D + MAX_FRAME];
    memcpy(sig, cng->cng_synth_state, sizeof(cng->cng_synth_state));
    int32_t seed = cng->rand_seed;
    for (int i = 0; i < length; i++) {
      seed = silk_rand(seed);
      sig[MAX_D + i] = cng->cng_exc_buf_q14[(seed >> 24) & exc_mask];
    }
    cng->rand_seed = seed;
    int16_t a_q12[MAX_D];
    nlsf2a(cng->cng_smth_nlsf_q15, st->lpc_order, a_q12);
    for (int i = 0; i < length; i++) {
      int32_t lpc_pred_q10 = st->lpc_order >> 1;
      for (int j = 0; j < st->lpc_order; j++)
        lpc_pred_q10 = SMLAWB(lpc_pred_q10, sig[MAX_D + i - 1 - j],
                              a_q12[j]);
      sig[MAX_D + i] = ADD_SAT32(sig[MAX_D + i],
                                 LSHIFT_SAT32(lpc_pred_q10, 4));
      int32_t add = SAT16(RSHIFT_ROUND(SMULWW(sig[MAX_D + i], gain_q10),
                                       8));
      int32_t v = frame[i] + add;
      frame[i] = (int16_t)SAT16(v);
    }
    memcpy(cng->cng_synth_state, sig + length,
           sizeof(cng->cng_synth_state));
  } else {
    memset(cng->cng_synth_state, 0, sizeof(cng->cng_synth_state));
  }
}

void decode_one_frame(SilkState* st, EcDec* dec, int cond_coding,
                      const uint8_t* contour_icdf,
                      const uint8_t* lag_low_icdf, int16_t* xq,
                      DecCtrl* ctrl_out, int* pulses_out, int lbrr = 0) {
  DecCtrl ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  decode_indices(st, dec, st->nframes_decoded, lbrr, cond_coding,
                 contour_icdf, lag_low_icdf, st->fs_khz >> 1);
  int pulses[MAX_FRAME + 16];
  decode_pulses(dec, st->ix.signal_type, st->ix.quant_offset_type,
                st->frame_length, pulses);
  decode_parameters(st, &ctrl, cond_coding);
#ifdef SILK_PLC_DEBUG
  fprintf(stderr, "dec: sig=%d lag=%d %d %d %d gains=%d %d %d %d scale=%d interp=%d a0=%d b0=%d\n",
          st->ix.signal_type, ctrl.pitch_l[0], ctrl.pitch_l[1],
          ctrl.pitch_l[2], ctrl.pitch_l[3], ctrl.gains_q16[0],
          ctrl.gains_q16[1], ctrl.gains_q16[2], ctrl.gains_q16[3],
          ctrl.ltp_scale_q14, st->ix.nlsf_interp_coef_q2,
          ctrl.pred_coef_q12[0][0], ctrl.ltp_coef_q14[0]);
#endif
  decode_core(st, &ctrl, pulses, xq);
  // PLC/CNG bookkeeping mirrors dec_api.decode_frame's clean path
  if (st->fs_khz != st->plc.fs_khz) {
    plc_reset(st);
    st->plc.fs_khz = st->fs_khz;
  }
  plc_update(st, &ctrl);  // also sets prev_signal_type
  st->loss_cnt = 0;
  st->first_frame_after_reset = 0;
  // out_buf shift + store (decode_frame postamble, clean path)
  int mv_len = st->ltp_mem_length - st->frame_length;
  memmove(st->out_buf, st->out_buf + st->frame_length,
          mv_len * sizeof(int16_t));
  memcpy(st->out_buf + mv_len, xq, st->frame_length * sizeof(int16_t));
  silk_cng(st, &ctrl, xq, st->frame_length);
  plc_glue_frames(st, xq, st->frame_length);
  st->lag_prev = ctrl.pitch_l[st->nb_subfr - 1];
  if (ctrl_out) *ctrl_out = ctrl;
  if (pulses_out)
    memcpy(pulses_out, pulses, st->frame_length * sizeof(int));
}

}  // namespace

// ------------------------------------------------------------------ C API
extern "C" {

void* silk_host_create() {
  SilkState* st = new SilkState();
  memset(st, 0, sizeof(*st));
  st->prev_gain_q16 = 65536;
  st->first_frame_after_reset = 1;
  st->last_gain_index = 10;
  return st;
}

void silk_host_destroy(void* p) { delete (SilkState*)p; }

void silk_host_reset(void* p) {
  SilkState* st = (SilkState*)p;
  memset(st, 0, sizeof(*st));
  st->prev_gain_q16 = 65536;
  st->first_frame_after_reset = 1;
  st->last_gain_index = 10;
}

// Decode a mono SILK payload (frame_ms in {10,20,40,60}) at the internal
// rate fs_khz in {8,12,16}. xq_out must hold fs_khz*frame_ms samples.
// Returns number of samples, or < 0 on error.
// As silk_host_decode, but optionally exports the final range-decoder
// state (ec_out[10] = {offs, rng, val, nbits_total, end_offs, end_window,
// nend_bits, error, rem, 0}) so a CELT plan decode can resume the same
// stream — the hybrid-mode handoff (reference opus_decoder.rs
// decode_frame passes one shared EcDec through SILK then CELT).
int silk_host_decode_ec(void* p, const uint8_t* data, int len, int fs_khz,
                        int frame_ms, int16_t* xq_out, uint32_t* ec_out) {
  SilkState* st = (SilkState*)p;
  if (!data || len < 1) return -1;
  int n_frames = frame_ms >= 20 ? frame_ms / 20 : 1;
  int sub_ms = frame_ms <= 20 ? frame_ms : 20;
  int nb_subfr = sub_ms == 20 ? 4 : 2;
  state_set_fs(st, fs_khz, nb_subfr);
  st->nframes_per_packet = n_frames;
  st->nframes_decoded = 0;

  const uint8_t* contour_icdf;
  if (fs_khz == 8)
    contour_icdf = nb_subfr == 4 ? kPITCH_CONTOUR_NB_ICDF
                                 : kPITCH_CONTOUR_10_MS_NB_ICDF;
  else
    contour_icdf = nb_subfr == 4 ? kPITCH_CONTOUR_ICDF
                                 : kPITCH_CONTOUR_10_MS_ICDF;
  const uint8_t* lag_low = fs_khz == 16 ? kSILK_UNIFORM8_ICDF
                           : (fs_khz == 12 ? kSILK_UNIFORM6_ICDF
                                           : kSILK_UNIFORM4_ICDF);

  EcDec dec;
  ec_dec_init(&dec, data, (uint32_t)len);
  // VAD + LBRR flags (mono)
  for (int i = 0; i < n_frames; i++)
    st->vad_flags[i] = ec_dec_bit_logp(&dec, 1);
  st->lbrr_flag = ec_dec_bit_logp(&dec, 1);
  for (int i = 0; i < 3; i++) st->lbrr_flags[i] = 0;
  if (st->lbrr_flag) {
    if (n_frames == 1) {
      st->lbrr_flags[0] = 1;
    } else {
      const uint8_t* icdf = n_frames == 2 ? kLBRR_FLAGS_ICDF0
                                          : kLBRR_FLAGS_ICDF1;
      int sym = ec_dec_icdf(&dec, icdf, 8) + 1;
      for (int i = 0; i < n_frames; i++)
        st->lbrr_flags[i] = (sym >> i) & 1;
    }
    // skip-parse LBRR frames so the stream position matches
    int16_t scratch[MAX_FRAME];
    for (int i = 0; i < n_frames; i++) {
      if (st->lbrr_flags[i]) {
        int cond = (i > 0 && st->lbrr_flags[i - 1]) ? 2 : 0;
        decode_indices(st, &dec, i, 1, cond, contour_icdf, lag_low,
                       fs_khz >> 1);
        int pulses[MAX_FRAME + 16];
        decode_pulses(&dec, st->ix.signal_type, st->ix.quant_offset_type,
                      st->frame_length, pulses);
        (void)scratch;
      }
    }
  }

  int total = 0;
  for (int i = 0; i < n_frames; i++) {
    int cond = i > 0 ? 2 : 0;
    decode_one_frame(st, &dec, cond, contour_icdf, lag_low, xq_out + total,
                     nullptr, nullptr);
    st->nframes_decoded++;
    total += st->frame_length;
  }
  st->last_rng = dec.rng;
  if (ec_out) {
    ec_out[0] = dec.offs;
    ec_out[1] = dec.rng;
    ec_out[2] = dec.val;
    ec_out[3] = (uint32_t)dec.nbits_total;
    ec_out[4] = dec.end_offs;
    ec_out[5] = dec.end_window;
    ec_out[6] = (uint32_t)dec.nend_bits;
    ec_out[7] = (uint32_t)dec.error;
    ec_out[8] = (uint32_t)dec.rem;
    ec_out[9] = 0;
  }
  return dec.error ? -2 : total;
}

int silk_host_decode(void* p, const uint8_t* data, int len, int fs_khz,
                     int frame_ms, int16_t* xq_out) {
  return silk_host_decode_ec(p, data, len, fs_khz, frame_ms, xq_out,
                             nullptr);
}

// Symbol-only decode for the SILK plan split (SURVEY.md §2.9.5): range
// decode + side info + excitation build on the host, exporting the dense
// per-frame parameters the batched device synthesis kernel
// (mousiki_tpu/ops/silk_synthesis_jax.py SilkFrameParams) consumes; the
// LTP/LPC synthesis itself is SKIPPED here — the device carries the
// out_hist/lpc_hist state. Single 20 ms mono frames (nb_subfr = 4), any
// internal rate. The host keeps every piece of state the NEXT symbol
// decode needs (gain index, NLSF history, lag_prev, signal type); its
// out_buf is NOT updated, so host-side PLC/CNG (which extrapolate from
// synthesized PCM) are unavailable in this mode — lossless-batch scope,
// mirroring the plan-mode CELT pipeline's v1 scope.
// Exports: exc_out[L] (exc_q14/2^14), a_out[2*16] (q12/2^12),
// b_out[4*5] (q14/2^14), pitch_out[4], gains_out[4] (q16/2^16),
// iflags[3] = {voiced, nlsf_interp, vad}, ltp_scale_out (q14/2^14).
// Returns frame_length or < 0 on error.
int silk_host_decode_symbols(void* p, const uint8_t* data, int len,
                             int fs_khz, float* exc_out, float* a_out,
                             float* b_out, int32_t* pitch_out,
                             float* gains_out, int32_t* iflags,
                             float* ltp_scale_out) {
  SilkState* st = (SilkState*)p;
  if (!data || len < 1) return -1;
  state_set_fs(st, fs_khz, 4);
  st->nframes_per_packet = 1;
  st->nframes_decoded = 0;

  const uint8_t* contour_icdf =
      fs_khz == 8 ? kPITCH_CONTOUR_NB_ICDF : kPITCH_CONTOUR_ICDF;
  const uint8_t* lag_low = fs_khz == 16 ? kSILK_UNIFORM8_ICDF
                           : (fs_khz == 12 ? kSILK_UNIFORM6_ICDF
                                           : kSILK_UNIFORM4_ICDF);
  EcDec dec;
  ec_dec_init(&dec, data, (uint32_t)len);
  st->vad_flags[0] = ec_dec_bit_logp(&dec, 1);
  st->lbrr_flag = ec_dec_bit_logp(&dec, 1);
  st->lbrr_flags[0] = 0;
  if (st->lbrr_flag) {
    // skip-parse the LBRR frame so the stream position matches
    st->lbrr_flags[0] = 1;
    decode_indices(st, &dec, 0, 1, 0, contour_icdf, lag_low, fs_khz >> 1);
    int pulses[MAX_FRAME + 16];
    decode_pulses(&dec, st->ix.signal_type, st->ix.quant_offset_type,
                  st->frame_length, pulses);
  }

  DecCtrl ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  decode_indices(st, &dec, 0, 0, 0, contour_icdf, lag_low, fs_khz >> 1);
  int pulses[MAX_FRAME + 16];
  decode_pulses(&dec, st->ix.signal_type, st->ix.quant_offset_type,
                st->frame_length, pulses);
  decode_parameters(st, &ctrl, 0);

  // excitation build (decode_core's first loop: LCG sign dither + offsets)
  SideInfo& ix = st->ix;
  int offset_q10 = (int)kSILK_QUANTIZATION_OFFSETS_Q10
      [ix.signal_type >> 1][ix.quant_offset_type];
  int32_t rand_seed = ix.seed;
  for (int i = 0; i < st->frame_length; i++) {
    rand_seed = silk_rand(rand_seed);
    int32_t v = I32((int64_t)pulses[i] << 14);
    if (v > 0) v -= QUANT_LEVEL_ADJUST_Q10 << 4;
    else if (v < 0) v += QUANT_LEVEL_ADJUST_Q10 << 4;
    v = I32((int64_t)v + (offset_q10 << 4));
    if (rand_seed < 0) v = -v;
    exc_out[i] = (float)(v * (1.0 / 16384.0));
    rand_seed = I32((int64_t)rand_seed + pulses[i]);
  }
  for (int h = 0; h < 2; h++)
    for (int j = 0; j < MAX_D; j++)
      a_out[h * MAX_D + j] =
          (float)(ctrl.pred_coef_q12[h][j] * (1.0 / 4096.0));
  for (int k = 0; k < 4; k++) {
    for (int j = 0; j < LTP_ORDER; j++)
      b_out[k * LTP_ORDER + j] =
          (float)(ctrl.ltp_coef_q14[k * LTP_ORDER + j] * (1.0 / 16384.0));
    pitch_out[k] = ctrl.pitch_l[k];
    gains_out[k] = (float)(ctrl.gains_q16[k] * (1.0 / 65536.0));
  }
  iflags[0] = ix.signal_type == 2;
  iflags[1] = ix.nlsf_interp_coef_q2 < 4;
  iflags[2] = st->vad_flags[0];
  // 0 means "not coded" (unvoiced / non-conditional frames): the device
  // kernel multiplies the rewhitened history by ltp_scale unconditionally,
  // so export the neutral 1.0 in that case (matches the device-kernel
  // parity test's mapping of decode_core's k==0 inv_gain*ltp_scale).
  *ltp_scale_out = ctrl.ltp_scale_q14
                       ? (float)(ctrl.ltp_scale_q14 * (1.0 / 16384.0))
                       : 1.0f;

  // state the next symbol decode depends on (decode_one_frame postamble,
  // minus everything that needs the synthesized PCM)
  st->prev_signal_type = ix.signal_type;
  st->loss_cnt = 0;
  st->first_frame_after_reset = 0;
  st->lag_prev = ctrl.pitch_l[st->nb_subfr - 1];
  st->prev_gain_q16 = ctrl.gains_q16[st->nb_subfr - 1];
  st->nframes_decoded = 1;
  st->last_rng = dec.rng;
  return dec.error ? -2 : st->frame_length;
}

// Decode the LBRR (in-band FEC) frame 0 of a 20 ms packet as the output
// frame — the decode_fec=1 path (dec_api FLAG_DECODE_LBRR; reference
// decode_frame.rs:26). Returns samples, or -20 when the packet carries
// no LBRR for this frame (caller falls back to PLC).
int silk_host_decode_lbrr(void* p, const uint8_t* data, int len,
                          int fs_khz, int16_t* xq_out) {
  SilkState* st = (SilkState*)p;
  if (!data || len < 1) return -1;
  state_set_fs(st, fs_khz, 4);
  st->nframes_per_packet = 1;
  st->nframes_decoded = 0;
  const uint8_t* contour_icdf =
      fs_khz == 8 ? kPITCH_CONTOUR_NB_ICDF : kPITCH_CONTOUR_ICDF;
  const uint8_t* lag_low = fs_khz == 16 ? kSILK_UNIFORM8_ICDF
                           : (fs_khz == 12 ? kSILK_UNIFORM6_ICDF
                                           : kSILK_UNIFORM4_ICDF);
  EcDec dec;
  ec_dec_init(&dec, data, (uint32_t)len);
  st->vad_flags[0] = ec_dec_bit_logp(&dec, 1);
  st->lbrr_flag = ec_dec_bit_logp(&dec, 1);
  if (!st->lbrr_flag) return -20;
  st->lbrr_flags[0] = 1;
  decode_one_frame(st, &dec, 0, contour_icdf, lag_low, xq_out, nullptr,
                   nullptr, /*lbrr=*/1);
  st->last_rng = dec.rng;
  return dec.error ? -2 : st->frame_length;
}

// Conceal one lost frame at the stream's current internal rate: classic
// LTP/LPC extrapolation + comfort noise (dec_api.decode_frame lost path;
// reference plc.rs / cng.rs). Writes frame_length int16 samples; returns
// the sample count (0 when the stream never decoded a frame).
int silk_host_plc(void* p, int16_t* xq_out) {
  SilkState* st = (SilkState*)p;
  if (st->fs_khz == 0 || st->frame_length == 0) return 0;
  if (st->fs_khz != st->plc.fs_khz) {
    plc_reset(st);
    st->plc.fs_khz = st->fs_khz;
  }
  DecCtrl ctrl;
  memset(&ctrl, 0, sizeof(ctrl));
  for (int i = 0; i < st->nb_subfr && i < 4; i++)
    ctrl.gains_q16[i] = 65536;
  st->ix.signal_type = st->prev_signal_type;
  memset(xq_out, 0, st->frame_length * sizeof(int16_t));
  plc_conceal(st, &ctrl, xq_out);
  st->loss_cnt++;
  int mv_len = st->ltp_mem_length - st->frame_length;
  memmove(st->out_buf, st->out_buf + st->frame_length,
          mv_len * sizeof(int16_t));
  memcpy(st->out_buf + mv_len, xq_out,
         st->frame_length * sizeof(int16_t));
  silk_cng(st, &ctrl, xq_out, st->frame_length);
  plc_glue_frames(st, xq_out, st->frame_length);
  st->lag_prev = ctrl.pitch_l[st->nb_subfr - 1];
  return st->frame_length;
}

uint32_t silk_host_rng(void* p) { return ((SilkState*)p)->last_rng; }

// Full decoder-state dump for parity debugging/tests.
void silk_host_dump(void* p, int16_t* out_buf, int32_t* s_lpc,
                    int32_t* ints) {
  SilkState* st = (SilkState*)p;
  memcpy(out_buf, st->out_buf, sizeof(st->out_buf));
  memcpy(s_lpc, st->s_lpc_q14_buf, sizeof(st->s_lpc_q14_buf));
  ints[0] = st->loss_cnt;
  ints[1] = st->prev_signal_type;
  ints[2] = st->lag_prev;
  ints[3] = st->prev_gain_q16;
  ints[4] = st->plc.rand_seed;
  ints[5] = st->plc.rand_scale_q14;
  ints[6] = st->plc.pitch_l_q8;
  ints[7] = st->cng.rand_seed;
  ints[8] = st->cng.cng_smth_gain_q16;
  ints[9] = st->first_frame_after_reset;
  for (int i = 0; i < MAX_D; i++) ints[10 + i] = st->prev_nlsf_q15[i];
}

// Debug/test introspection of the PLC bookkeeping.
void silk_host_plc_state(void* p, int32_t* out8) {
  SilkState* st = (SilkState*)p;
  out8[0] = st->loss_cnt;
  out8[1] = st->plc.conc_energy;
  out8[2] = st->plc.conc_energy_shift;
  out8[3] = st->plc.last_frame_lost;
  out8[4] = st->plc.rand_scale_q14;
  out8[5] = st->plc.pitch_l_q8;
  out8[6] = st->plc.prev_gain_q16[1];
  out8[7] = st->cng.cng_smth_gain_q16;
}

}  // extern "C"

// ===================================================================
// Stereo SILK: joint mid/side packet decode + MS->LR unmix for the
// unified pipeline (mirrors silk/dec_api.py silk_decode n_channels=2;
// reference src/silk/{dec_api,stereo_decode_pred,stereo_ms_to_lr}.rs).
// The caller owns two SilkState (mid, side) plus a 7-int stereo state:
// [s_mid0, s_mid1, s_side0, s_side1, pred_prev0, pred_prev1,
//  prev_decode_only_middle].
// ===================================================================
namespace {

const uint8_t kSTEREO_PRED_JOINT_ICDF[25] = {
    249, 247, 246, 245, 244, 234, 210, 202, 201, 200, 197, 174, 82,
    59,  56,  55,  54,  46,  22,  12,  11,  10,  9,   7,   0};
const int16_t kSTEREO_PRED_QUANT_Q13[16] = {
    -13732, -10050, -8266, -7526, -6500, -5000, -2950, -820,
    820,    2950,   5000,  6500,  7526,  8266,  10050, 13732};
const uint8_t kSTEREO_ONLY_CODE_MID_ICDF[2] = {64, 0};
constexpr int STEREO_INTERP_LEN_MS = 8;

inline int32_t SMLABB(int32_t a, int32_t b, int32_t c) {
  return I32((int64_t)a + (int16_t)b * (int16_t)c);
}

void stereo_decode_pred_c(EcDec* dec, int32_t* pred_q13) {
  int n = ec_dec_icdf(dec, kSTEREO_PRED_JOINT_ICDF, 8);
  int ix[2][3];
  ix[0][2] = n / 5;
  ix[1][2] = n - 5 * ix[0][2];
  for (int ch = 0; ch < 2; ch++) {
    ix[ch][0] = ec_dec_icdf(dec, kSILK_UNIFORM3_ICDF, 8);
    ix[ch][1] = ec_dec_icdf(dec, kSILK_UNIFORM5_ICDF, 8);
  }
  for (int ch = 0; ch < 2; ch++) {
    ix[ch][0] += 3 * ix[ch][2];
    int32_t low = kSTEREO_PRED_QUANT_Q13[ix[ch][0]];
    int32_t step = SMULWB(
        kSTEREO_PRED_QUANT_Q13[ix[ch][0] + 1] - low, 6554);
    pred_q13[ch] = SMLABB(low, step, 2 * ix[ch][1] + 1);
  }
  pred_q13[0] -= pred_q13[1];
}

// In-place MS->LR; x1/x2 carry 2 leading history samples.
void stereo_ms_to_lr_c(int32_t* sst, int16_t* x1, int16_t* x2,
                       const int32_t* pred_q13, int fs_khz, int L) {
  x1[0] = (int16_t)sst[0];
  x1[1] = (int16_t)sst[1];
  x2[0] = (int16_t)sst[2];
  x2[1] = (int16_t)sst[3];
  sst[0] = x1[L];
  sst[1] = x1[L + 1];
  sst[2] = x2[L];
  sst[3] = x2[L + 1];

  int32_t pred0 = sst[4];
  int32_t pred1 = sst[5];
  int interp_len = STEREO_INTERP_LEN_MS * fs_khz;
  int32_t denom_q16 = (1 << 16) / interp_len;
  int32_t delta0 = RSHIFT_ROUND(
      SMULBB(pred_q13[0] - sst[4], denom_q16), 16);
  int32_t delta1 = RSHIFT_ROUND(
      SMULBB(pred_q13[1] - sst[5], denom_q16), 16);
  for (int n = 0; n < interp_len; n++) {
    pred0 += delta0;
    pred1 += delta1;
    int32_t s = I32((int64_t)(I32((int64_t)x1[n] + x1[n + 2]) +
                              ((int32_t)x1[n + 1] << 1))
                    << 9);
    s = SMLAWB(I32((int64_t)x2[n + 1] << 8), s, pred0);
    s = SMLAWB(s, I32((int64_t)x1[n + 1] << 11), pred1);
    x2[n + 1] = (int16_t)SAT16(RSHIFT_ROUND(s, 8));
  }
  pred0 = pred_q13[0];
  pred1 = pred_q13[1];
  for (int n = interp_len; n < L; n++) {
    int32_t s = I32((int64_t)(I32((int64_t)x1[n] + x1[n + 2]) +
                              ((int32_t)x1[n + 1] << 1))
                    << 9);
    s = SMLAWB(I32((int64_t)x2[n + 1] << 8), s, pred0);
    s = SMLAWB(s, I32((int64_t)x1[n + 1] << 11), pred1);
    x2[n + 1] = (int16_t)SAT16(RSHIFT_ROUND(s, 8));
  }
  sst[4] = pred_q13[0];
  sst[5] = pred_q13[1];

  for (int n = 0; n < L; n++) {
    int32_t s = (int32_t)x1[n + 1] + x2[n + 1];
    int32_t d = (int32_t)x1[n + 1] - x2[n + 1];
    x1[n + 1] = (int16_t)SAT16(s);
    x2[n + 1] = (int16_t)SAT16(d);
  }
}

}  // namespace

extern "C" {

// Decode a stereo SILK frame (10-60 ms payload) into left/right PCM at
// the internal rate. mid_p/side_p: two silk_host states. sst: the 7-int
// stereo state (see header comment). out_l/out_r hold fs_khz*frame_ms
// samples. Returns samples per channel or < 0.
int silk_host_decode_stereo(void* mid_p, void* side_p, int32_t* sst,
                            const uint8_t* data, int len, int fs_khz,
                            int frame_ms, int16_t* out_l, int16_t* out_r,
                            uint32_t* ec_out) {
  SilkState* cs[2] = {(SilkState*)mid_p, (SilkState*)side_p};
  if (!data || len < 1) return -1;
  int n_frames = frame_ms >= 20 ? frame_ms / 20 : 1;
  int sub_ms = frame_ms <= 20 ? frame_ms : 20;
  int nb_subfr = sub_ms == 20 ? 4 : 2;
  for (int n = 0; n < 2; n++) {
    state_set_fs(cs[n], fs_khz, nb_subfr);
    cs[n]->nframes_per_packet = n_frames;
    cs[n]->nframes_decoded = 0;
  }

  const uint8_t* contour_icdf;
  if (fs_khz == 8)
    contour_icdf = nb_subfr == 4 ? kPITCH_CONTOUR_NB_ICDF
                                 : kPITCH_CONTOUR_10_MS_NB_ICDF;
  else
    contour_icdf = nb_subfr == 4 ? kPITCH_CONTOUR_ICDF
                                 : kPITCH_CONTOUR_10_MS_ICDF;
  const uint8_t* lag_low = fs_khz == 16 ? kSILK_UNIFORM8_ICDF
                           : (fs_khz == 12 ? kSILK_UNIFORM6_ICDF
                                           : kSILK_UNIFORM4_ICDF);

  EcDec dec;
  ec_dec_init(&dec, data, (uint32_t)len);

  // VAD + LBRR flags, both channels (dec_api.py:234)
  for (int n = 0; n < 2; n++) {
    for (int i = 0; i < n_frames; i++)
      cs[n]->vad_flags[i] = ec_dec_bit_logp(&dec, 1);
    cs[n]->lbrr_flag = ec_dec_bit_logp(&dec, 1);
  }
  for (int n = 0; n < 2; n++) {
    for (int i = 0; i < 3; i++) cs[n]->lbrr_flags[i] = 0;
    if (cs[n]->lbrr_flag) {
      if (n_frames == 1) {
        cs[n]->lbrr_flags[0] = 1;
      } else {
        const uint8_t* icdf =
            n_frames == 2 ? kLBRR_FLAGS_ICDF0 : kLBRR_FLAGS_ICDF1;
        int sym = ec_dec_icdf(&dec, icdf, 8) + 1;
        for (int i = 0; i < n_frames; i++)
          cs[n]->lbrr_flags[i] = (sym >> i) & 1;
      }
    }
  }
  // skip-parse LBRR data, channel-interleaved per frame (dec_api.py:251)
  for (int i = 0; i < n_frames; i++) {
    for (int n = 0; n < 2; n++) {
      if (cs[n]->lbrr_flags[i]) {
        if (n == 0) {
          int32_t pq[2];
          stereo_decode_pred_c(&dec, pq);
          if (cs[1]->lbrr_flags[i] == 0)
            ec_dec_icdf(&dec, kSTEREO_ONLY_CODE_MID_ICDF, 8);
        }
        int cond = (i > 0 && cs[n]->lbrr_flags[i - 1]) ? 2 : 0;
        decode_indices(cs[n], &dec, i, 1, cond, contour_icdf, lag_low,
                       fs_khz >> 1);
        int pulses[MAX_FRAME + 16];
        decode_pulses(&dec, cs[n]->ix.signal_type,
                      cs[n]->ix.quant_offset_type, cs[n]->frame_length,
                      pulses);
      }
    }
  }

  int L = cs[0]->frame_length;
  int total = 0;
  // 2 history samples + up to 60 ms at 16 kHz
  int16_t x1[2 + 960], x2[2 + 960];
  for (int i = 0; i < n_frames; i++) {
    int32_t ms_pred_q13[2];
    stereo_decode_pred_c(&dec, ms_pred_q13);
    int decode_only_middle = 0;
    if (cs[1]->vad_flags[i] == 0)
      decode_only_middle = ec_dec_icdf(&dec, kSTEREO_ONLY_CODE_MID_ICDF, 8);

    if (decode_only_middle == 0 && sst[6] == 1) {
      // side channel comes back after a mid-only stretch: reset it
      // (dec_api.py:283)
      memset(cs[1]->out_buf, 0, sizeof(cs[1]->out_buf));
      memset(cs[1]->s_lpc_q14_buf, 0, sizeof(cs[1]->s_lpc_q14_buf));
      cs[1]->lag_prev = 0;
      cs[1]->last_gain_index = 10;
      cs[1]->prev_signal_type = 0;
      cs[1]->first_frame_after_reset = 1;
    }
    int has_side = decode_only_middle == 0;

    for (int n = 0; n < 2; n++) {
      int16_t* xbuf = n == 0 ? x1 : x2;
      if (n == 0 || has_side) {
        int frame_index = cs[0]->nframes_decoded - n;
        int cond;
        if (frame_index <= 0)
          cond = 0;  // CODE_INDEPENDENTLY
        else if (n > 0 && sst[6])
          cond = 1;  // CODE_INDEPENDENTLY_NO_LTP_SCALING
        else
          cond = 2;  // CODE_CONDITIONALLY
        decode_one_frame(cs[n], &dec, cond, contour_icdf, lag_low,
                         xbuf + 2, nullptr, nullptr);
      } else {
        memset(xbuf + 2, 0, L * sizeof(int16_t));
      }
      cs[n]->nframes_decoded++;
    }

#ifdef SILK_STEREO_SKIP_UNMIX
    memcpy(out_l + total, x1 + 2, L * sizeof(int16_t));
    memcpy(out_r + total, x2 + 2, L * sizeof(int16_t));
    (void)ms_pred_q13;
#else
    stereo_ms_to_lr_c(sst, x1, x2, ms_pred_q13, fs_khz, L);
    memcpy(out_l + total, x1 + 1, L * sizeof(int16_t));
    memcpy(out_r + total, x2 + 1, L * sizeof(int16_t));
#endif
    sst[6] = decode_only_middle;
    total += L;
  }
  cs[0]->last_rng = dec.rng;
  if (ec_out) {  // stereo-hybrid handoff (see silk_host_decode_ec)
    ec_out[0] = dec.offs;
    ec_out[1] = dec.rng;
    ec_out[2] = dec.val;
    ec_out[3] = (uint32_t)dec.nbits_total;
    ec_out[4] = dec.end_offs;
    ec_out[5] = dec.end_window;
    ec_out[6] = (uint32_t)dec.nend_bits;
    ec_out[7] = (uint32_t)dec.error;
    ec_out[8] = (uint32_t)dec.rem;
    ec_out[9] = 0;
  }
  return dec.error ? -2 : total;
}

// Stereo SILK PLC: conceal one 20 ms frame per channel, then MS->LR
// with the previous predictors (dec_api.py lost path).
int silk_host_plc_stereo(void* mid_p, void* side_p, int32_t* sst,
                         int16_t* out_l, int16_t* out_r) {
  SilkState* cs[2] = {(SilkState*)mid_p, (SilkState*)side_p};
  int L = cs[0]->frame_length;
  if (L <= 0) return -1;
  int16_t x1[2 + 960], x2[2 + 960];
  int32_t pred[2] = {sst[4], sst[5]};
  for (int n = 0; n < 2; n++) {
    int16_t* xbuf = n == 0 ? x1 : x2;
    int has_side = !sst[6];
    if (n == 0 || has_side)
      silk_host_plc(cs[n], xbuf + 2);
    else
      memset(xbuf + 2, 0, L * sizeof(int16_t));
  }
  stereo_ms_to_lr_c(sst, x1, x2, pred, cs[0]->fs_khz, L);
  memcpy(out_l, x1 + 1, L * sizeof(int16_t));
  memcpy(out_r, x2 + 1, L * sizeof(int16_t));
  return L;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Delayed-decision noise-shaping quantizer, float64 twin of
// mousiki_tpu/silk/nsq_del_dec.py (behavioral port of the reference
// nsq_del_dec.rs:83 silk_NSQ_del_dec with the corrected monic-warped
// conversion — see silk/noise_shape.py _warped_true2monic). Same state
// contract: persistent buffers in the gain-scaled double domain, unscaled
// xq history for LTP re-whitening. The Python twin is the tested
// reference; this exists for encode serving throughput.
// ---------------------------------------------------------------------------

namespace nsqdd {

constexpr int kDD = 40;          // DECISION_DELAY
constexpr int kMaxStates = 4;
constexpr int kLpcBuf = 32;      // NSQ_LPC_BUF
constexpr int kMaxSub = 160;
constexpr int kMaxOrder = 24;
constexpr double kBigRd = 134217728.0;  // 2^27
constexpr double kQuantAdj = 80.0 / 1024.0;

struct DDState {
  double s_lpc[kLpcBuf + kMaxSub];
  double s_ar2[kMaxOrder];
  double r_q[kDD], r_xq[kDD], r_pred[kDD], r_shape[kDD];
  int32_t r_rand[kDD];
  double lf_ar, diff, rd;
  int32_t seed, seed_init;
};

static inline int32_t silk_rand_i32(int32_t s) {
  return (int32_t)(907633515u + (uint32_t)s * 196314165u);
}

static inline int iround_half_up(double q) {
  return (int)std::floor(q + 0.5);
}

}  // namespace nsqdd

extern "C" {

// Returns the winner's initial seed index (>= 0) or -1 on bad args.
// All pointers are caller-owned numpy buffers (see silk/nsq_del_dec.py
// nsq_del_dec_native). State arrays are updated in place.
int silk_nsq_del_dec_f64(
    const double* x, int frame_length, int nb_subfr, int signal_type,
    int seed, int ltp_mem_length, int lpc_order,
    const double* pred_coef,   // (2, lpc_order): a values (already /4096)
    const double* ltp_coef,    // (nb_subfr*5): b values (already /16384)
    const int32_t* gains_q16, const int32_t* pitch_l,
    int ltp_scale_q14, int nlsf_interp_flag, int n_states, double warping,
    const double* ar_shp,      // (nb_subfr, order) shaping coefs
    int order,                 // shaping/chain order (= len(s_ar2), 24)
    const double* harm_v, const double* tilt_v, const double* lf_ma_v,
    const double* lf_ar_v, double lambda_, double offset,
    double* xq_all,            // 2*ltp_mem, unscaled emitted output
    double* shp,               // 2*ltp_mem, scaled shape history
    double* s_lpc_st,          // kLpcBuf persistent
    double* s_ar2_st,          // order persistent
    double* scal,              // [s_lf_ar, s_diff, prev_gain] in/out
    int32_t* lag_prev_io,      // [lag_prev] in/out
    int32_t* pulses)           // frame_length out
{
  using namespace nsqdd;
  if (n_states < 1 || n_states > kMaxStates || order > kMaxOrder)
    return -1;
  const int sub = frame_length / nb_subfr;
  if (sub > kMaxSub) return -1;
  const bool voiced = signal_type == 2;
  const int N = n_states;
  const double lam = lambda_;

  int lag = lag_prev_io[0];
  double prev_gain = scal[2];

  static thread_local DDState st[kMaxStates];
  for (int k = 0; k < N; k++) {
    DDState& d = st[k];
    d.seed = (int32_t)((k + (seed & 3)) & 3);
    d.seed_init = d.seed;
    d.rd = 0.0;
    d.lf_ar = scal[0];
    d.diff = scal[1];
    memcpy(d.s_lpc, s_lpc_st, kLpcBuf * sizeof(double));
    memset(d.s_lpc + kLpcBuf, 0, kMaxSub * sizeof(double));
    memcpy(d.s_ar2, s_ar2_st, order * sizeof(double));
    memset(d.r_q, 0, sizeof(d.r_q));
    memset(d.r_xq, 0, sizeof(d.r_xq));
    memset(d.r_pred, 0, sizeof(d.r_pred));
    memset(d.r_shape, 0, sizeof(d.r_shape));
    memset(d.r_rand, 0, sizeof(d.r_rand));
    d.r_shape[0] = shp[ltp_mem_length - 1];
  }

  int smpl_buf_idx = 0;
  int decision_delay = kDD < sub ? kDD : sub;
  if (voiced) {
    for (int k = 0; k < nb_subfr; k++) {
      int v = pitch_l[k] - 2 - 1;
      if (v < 0) v = 0;
      if (v < decision_delay) decision_delay = v;
    }
  } else if (lag > 0) {
    int v = lag - 2 - 1;
    if (v < 0) v = 0;
    if (v < decision_delay) decision_delay = v;
  }
  double delayed_gain[kDD];
  memset(delayed_gain, 0, sizeof(delayed_gain));

  std::vector<double> s_ltp(ltp_mem_length + frame_length, 0.0);
  std::vector<double> s_ltp_sc(ltp_mem_length + frame_length, 0.0);
  int shp_buf_idx = ltp_mem_length;
  int ltp_buf_idx = ltp_mem_length;
  int subfr = 0;

  auto flush = [&](int count, double gain, int pulses_off, int xq_off) {
    int win = 0;
    for (int k = 1; k < N; k++)
      if (st[k].rd < st[win].rd) win = k;
    for (int k = 0; k < N; k++)
      if (k != win) st[k].rd += kBigRd;
    int last = (smpl_buf_idx + decision_delay) % kDD;
    for (int i = 0; i < count; i++) {
      last = (last + kDD - 1) % kDD;
      pulses[pulses_off + i - decision_delay] =
          iround_half_up(st[win].r_q[last]);
      xq_all[xq_off + i - decision_delay] = st[win].r_xq[last] * gain;
      shp[shp_buf_idx - decision_delay + i] = st[win].r_shape[last];
    }
    return win;
  };

  for (int k = 0; k < nb_subfr; k++) {
    const int fo = k * sub;
    const int half_raw = (k >> 1) | (nlsf_interp_flag ? 0 : 1);
    const int half = half_raw > 1 ? 1 : half_raw;
    const double* a = pred_coef + half * lpc_order;
    const double* b = ltp_coef + k * 5;
    const double* c_shp = ar_shp + k * order;
    const double gain =
        (double)(gains_q16[k] > 1 ? gains_q16[k] : 1) / 65536.0;
    const double inv_gain = 1.0 / gain;

    bool rewhite = false;
    if (voiced) {
      lag = pitch_l[k];
      if ((k & (3 - (nlsf_interp_flag ? 2 : 0))) == 0) {
        if (k == 2) {
          double g1 = (double)(gains_q16[1] > 1 ? gains_q16[1] : 1) / 65536.0;
          flush(decision_delay, g1, fo, ltp_mem_length + fo);
          subfr = 0;
        }
        int start = ltp_mem_length - lag - lpc_order - 2;
        if (start < 1) start = 1;
        // whiten the unscaled emitted xq history with this half's LPC
        const double* seg = xq_all + start + fo;
        const int seglen = ltp_mem_length - start;
        for (int i = 0; i < seglen; i++) {
          double r = seg[i];
          for (int j = 0; j < lpc_order && j < i; j++)
            r -= a[j] * seg[i - 1 - j];
          s_ltp[start + i] = i < lpc_order ? 0.0 : r;
        }
        rewhite = true;
        ltp_buf_idx = ltp_mem_length;
      }
    }

    // scale_states
    double x_sc[kMaxSub];
    for (int i = 0; i < sub; i++) x_sc[i] = x[fo + i] * inv_gain;
    if (rewhite) {
      double ig = inv_gain;
      if (k == 0) ig *= (double)ltp_scale_q14 / 16384.0;
      int lo = ltp_buf_idx - lag - 2;
      for (int i = lo; i < ltp_buf_idx; i++) s_ltp_sc[i] = s_ltp[i] * ig;
    }
    if (gain != prev_gain) {
      double adj = prev_gain / gain;
      for (int i = shp_buf_idx - ltp_mem_length; i < shp_buf_idx; i++)
        shp[i] *= adj;
      if (voiced && !rewhite) {
        int lo = ltp_buf_idx - lag - 2;
        for (int i = lo; i < ltp_buf_idx - decision_delay; i++)
          s_ltp_sc[i] *= adj;
      }
      for (int kk = 0; kk < N; kk++) {
        DDState& d = st[kk];
        d.lf_ar *= adj;
        d.diff *= adj;
        for (int i = 0; i < kLpcBuf + sub; i++) d.s_lpc[i] *= adj;
        for (int i = 0; i < order; i++) d.s_ar2[i] *= adj;
        for (int i = 0; i < kDD; i++) {
          d.r_pred[i] *= adj;
          d.r_shape[i] *= adj;
        }
      }
      prev_gain = gain;
    }

    int shp_lag = shp_buf_idx - lag + 1;
    int pred_lag = ltp_buf_idx - lag + 2;
    const double harm = harm_v[k], tilt = tilt_v[k];
    const double lf_ma = lf_ma_v[k], lf_ar_c = lf_ar_v[k];
    int lpc_off = kLpcBuf - 1;

    for (int i = 0; i < sub; i++) {
      double ltp_pred = 0.0;
      if (voiced) {
        for (int j = 0; j < 5; j++)
          ltp_pred += b[j] * s_ltp_sc[pred_lag - j];
        pred_lag++;
      }
      double n_ltp = 0.0;
      if (lag > 0) {
        n_ltp = harm * (0.25 * (shp[shp_lag] + shp[shp_lag - 2]) +
                        0.5 * shp[shp_lag - 1]);
        shp_lag++;
      }

      smpl_buf_idx = (smpl_buf_idx + kDD - 1) % kDD;
      const int last = (smpl_buf_idx + decision_delay) % kDD;

      struct Cand {
        double q, rd, xq, diff, lfar, shape, lexc;
      } c0[kMaxStates], c1[kMaxStates];
      double sgn_k[kMaxStates];

      for (int kk = 0; kk < N; kk++) {
        DDState& d = st[kk];
        d.seed = silk_rand_i32(d.seed);
        const double sgn = d.seed < 0 ? -1.0 : 1.0;
        sgn_k[kk] = sgn;

        double lpc_pred = 0.0;
        for (int j = 0; j < lpc_order; j++)
          lpc_pred += a[j] * d.s_lpc[lpc_off - j];

        double n_ar = d.lf_ar * tilt;
        for (int j = 0; j < order; j++) n_ar += c_shp[j] * d.s_ar2[j];

        // n_lf reads the PRE-decrement ring slot: the Python twin reads
        // r_shape[smpl_buf_idx] before decrementing; we already
        // decremented, so the previous index is (smpl_buf_idx+1)%kDD
        const int prev_idx = (smpl_buf_idx + 1) % kDD;
        double n_lf = lf_ma * d.r_shape[prev_idx] + lf_ar_c * d.lf_ar;

        double r = x_sc[i] - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp);
        r = sgn * r;
        if (r < -31.0) r = -31.0;
        if (r > 30.0) r = 30.0;

        double q_ideal = r - offset;
        double q0 = std::floor(q_ideal);
        if (lam > 2.0) {
          double rdo = 0.5 * lam - 0.5;
          if (q_ideal > rdo) q0 = std::floor(q_ideal - rdo);
          else if (q_ideal < -rdo) q0 = std::floor(q_ideal + rdo);
          else if (q_ideal < 0.0) q0 = -1.0;
          else q0 = 0.0;
        }
        double v1, v2;
        if (q0 > 0) {
          v1 = q0 - kQuantAdj + offset;
          v2 = v1 + 1.0;
        } else if (q0 == 0) {
          v1 = offset;
          v2 = v1 + (1.0 - kQuantAdj);
        } else if (q0 == -1) {
          v1 = offset - (1.0 - kQuantAdj);
          v2 = offset;
        } else {
          v1 = q0 + kQuantAdj + offset;
          v2 = v1 + 1.0;
        }
        double rd1 = lam * std::fabs(v1) + (r - v1) * (r - v1);
        double rd2 = lam * std::fabs(v2) + (r - v2) * (r - v2);
        double q_a = v1, q_b = v2, rd_a = rd1, rd_b = rd2;
        if (rd2 < rd1) {
          q_a = v2; q_b = v1; rd_a = rd2; rd_b = rd1;
        }
        auto fill = [&](Cand& c, double vq, double rdv) {
          const double exc = sgn * vq;
          const double lexc = exc + ltp_pred;
          const double xq = lexc + lpc_pred;
          const double df = xq - x_sc[i];
          const double lfar = df - n_ar;
          c.q = vq; c.rd = d.rd + rdv; c.xq = xq; c.diff = df;
          c.lfar = lfar; c.shape = lfar - n_lf; c.lexc = lexc;
        };
        fill(c0[kk], q_a, rd_a);
        fill(c1[kk], q_b, rd_b);
      }

      // winner by head rd; penalize rand-state disagreement
      int win = 0;
      for (int kk = 1; kk < N; kk++)
        if (c0[kk].rd < c0[win].rd) win = kk;
      const int32_t wseed = st[win].r_rand[last];
      for (int kk = 0; kk < N; kk++) {
        if (st[kk].r_rand[last] != wseed) {
          c0[kk].rd += kBigRd;
          c1[kk].rd += kBigRd;
        }
      }
      // replace worst head with best runner-up
      int mx = 0, mn = 0;
      for (int kk = 1; kk < N; kk++) {
        if (c0[kk].rd > c0[mx].rd) mx = kk;
        if (c1[kk].rd < c1[mn].rd) mn = kk;
      }
      if (c1[mn].rd < c0[mx].rd) {
        st[mx] = st[mn];  // copies seed/lf_ar/diff/rings/s_lpc/s_ar2
        c0[mx] = c1[mn];
        sgn_k[mx] = sgn_k[mn];
      }

      // delayed emission from the (post-replacement) winner
      if (subfr > 0 || i >= decision_delay) {
        pulses[fo + i - decision_delay] =
            iround_half_up(st[win].r_q[last]);
        xq_all[ltp_mem_length + fo + i - decision_delay] =
            st[win].r_xq[last] * delayed_gain[last];
        shp[shp_buf_idx - decision_delay] = st[win].r_shape[last];
        s_ltp_sc[ltp_buf_idx - decision_delay] = st[win].r_pred[last];
      }
      shp_buf_idx++;
      ltp_buf_idx++;

      // advance every state with its head candidate; rotate the warped
      // allpass chain with the chosen diff (reference in-loop rotation)
      lpc_off++;
      for (int kk = 0; kk < N; kk++) {
        DDState& d = st[kk];
        const Cand& c = c0[kk];
        const double w = warping;
        double tmp2 = c.diff + w * d.s_ar2[0];
        double tmp1 = d.s_ar2[0] + w * (d.s_ar2[1] - tmp2);
        d.s_ar2[0] = tmp2;
        for (int j = 2; j < order; j += 2) {
          tmp2 = d.s_ar2[j - 1] + w * (d.s_ar2[j] - tmp1);
          d.s_ar2[j - 1] = tmp1;
          tmp1 = d.s_ar2[j] + w * (d.s_ar2[j + 1] - tmp2);
          d.s_ar2[j] = tmp2;
        }
        d.s_ar2[order - 1] = tmp1;

        d.lf_ar = c.lfar;
        d.diff = c.diff;
        d.s_lpc[lpc_off] = c.xq;
        d.r_xq[smpl_buf_idx] = c.xq;
        d.r_q[smpl_buf_idx] = c.q;
        d.r_pred[smpl_buf_idx] = c.lexc;
        d.r_shape[smpl_buf_idx] = c.shape;
        d.seed = (int32_t)((uint32_t)d.seed +
                           (uint32_t)(int32_t)iround_half_up(c.q));
        d.r_rand[smpl_buf_idx] = d.seed;
        d.rd = c.rd;
      }
      delayed_gain[smpl_buf_idx] = gain;
    }

    for (int kk = 0; kk < N; kk++)
      memmove(st[kk].s_lpc, st[kk].s_lpc + sub, kLpcBuf * sizeof(double));
    subfr++;
  }

  double glast = (double)(gains_q16[nb_subfr - 1] > 1 ?
                          gains_q16[nb_subfr - 1] : 1) / 65536.0;
  int win = flush(decision_delay, glast, frame_length,
                  ltp_mem_length + frame_length);
  memcpy(s_lpc_st, st[win].s_lpc, kLpcBuf * sizeof(double));
  memcpy(s_ar2_st, st[win].s_ar2, order * sizeof(double));
  scal[0] = st[win].lf_ar;
  scal[1] = st[win].diff;
  scal[2] = prev_gain;
  lag_prev_io[0] = voiced ? pitch_l[nb_subfr - 1] : 0;

  memmove(xq_all, xq_all + frame_length, ltp_mem_length * sizeof(double));
  memmove(shp, shp + frame_length, ltp_mem_length * sizeof(double));
  return st[win].seed_init;
}

}  // extern "C"
