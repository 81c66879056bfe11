// Unified Opus host stage: TOC-routed symbol decode for mixed
// SILK / CELT / hybrid 20 ms traffic feeding one batched device step.
//
// Mirrors the reference's per-stream routing (src/opus_decoder.rs:453
// decode_frame): SILK frames run the native SILK decoder at the internal
// rate, hybrid frames run SILK then resume the SAME range decoder into
// the CELT plan decode (start band 17), CELT frames run the plan decode
// directly. Outputs: packed CELT band plans (celt_host.cpp layout),
// 16 kHz SILK pcm, and a per-stream mode tag. Build together with
// celt_host.cpp and silk_host.cpp into libopus_host.so (see
// mousiki_tpu/opus_host_native.py).
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <atomic>
#include <vector>

extern "C" {
// celt_host.cpp
int celt_host_decode_plan(void* p, const uint8_t* data, int len,
                          int frame_size, int C, int start, int end,
                          int disable_inv, void** arrs, int S, int s);
int celt_host_decode_plan_resume(void* p, const uint8_t* data, int len,
                                 int frame_size, int C, int start, int end,
                                 int disable_inv, void** arrs, int S, int s,
                                 const uint32_t* ec_in);
int celt_host_hybrid_redundancy(uint32_t* ec, const uint8_t* data, int len,
                                int32_t* out);
int celt_host_decode_resume(void* p, const uint8_t* data, int len,
                            int frame_size, int C, int start, int end,
                            int disable_inv, float* x_out,
                            double* band_log_e, int32_t* iflags,
                            double* pf_gain, const uint32_t* ec_in);
void celt_host_plan_clear_stream(void** arrs, int s);
// silk_host.cpp
int silk_host_decode_ec(void* p, const uint8_t* data, int len, int fs_khz,
                        int frame_ms, int16_t* xq_out, uint32_t* ec_out);
int silk_host_plc(void* p, int16_t* xq_out);
int silk_host_decode_lbrr(void* p, const uint8_t* data, int len,
                          int fs_khz, int16_t* xq_out);
int silk_host_decode_stereo(void* mid_p, void* side_p, int32_t* sst,
                            const uint8_t* data, int len, int fs_khz,
                            int frame_ms, int16_t* out_l, int16_t* out_r,
                            uint32_t* ec_out);
int silk_host_plc_stereo(void* mid_p, void* side_p, int32_t* sst,
                         int16_t* out_l, int16_t* out_r);
int silk_host_decode_symbols(void* p, const uint8_t* data, int len,
                             int fs_khz, float* exc_out, float* a_out,
                             float* b_out, int32_t* pitch_out,
                             float* gains_out, int32_t* iflags,
                             float* ltp_scale_out);
void celt_host_note_loss(void* p);
}

namespace {
// LBRR routing for a lost frame: decode the NEXT packet's in-band FEC
// (SILK/hybrid only; 20 ms mono code-0). Returns the SILK internal rate
// in kHz on success, 0 to fall back to PLC.
int try_lbrr(void* silk_st, const uint8_t* pkt, int len, int16_t* silk16) {
  if (!pkt || len < 1) return 0;
  int toc = pkt[0];
  int config = toc >> 3;
  if ((toc >> 2) & 1) return 0;       // stereo-coded: per-stream fallback
  if ((toc & 3) != 0) return 0;       // code 0 only
  if (config >= 16) return 0;         // CELT has no in-band FEC
  int fs;
  if (config >= 12) {                 // hybrid (odd = 20 ms)
    if ((config & 1) != 1) return 0;
    fs = 16;
  } else {
    if ((config & 3) != 1) return 0;  // 20 ms only
    fs = config < 4 ? 8 : (config < 8 ? 12 : 16);
  }
  int n = silk_host_decode_lbrr(silk_st, pkt + 1, len - 1, fs, silk16);
  return n > 0 ? fs : 0;
}
}  // namespace

// Per-stream SilkFrameParams wire layout for the device-synthesis
// opt-in: floats [exc 320 | a 32 | b 20 | gains 4 | ltp_scale 1] = 377,
// ints [pitch 4 | voiced, interp, vad 3] = 7.
static constexpr int kSilkParamF = 377;
static constexpr int kSilkParamI = 7;

extern "C" {

// Decode one 20 ms Opus packet for stream s.
//   modes[s]:  0 = CELT, 1 = SILK, 2 = hybrid
//   silk16:    320 int16 at the SILK internal rate (fs*20 valid samples,
//              tail zeroed; zeroed entirely for CELT-only frames)
//   fs_out[s]: SILK internal rate in kHz (8/12/16; 16 for CELT/hybrid)
// Returns 0 / negative error (-10 multiframe, -11 non-20ms,
// -14 channel-count mismatch vs the pipeline layout, decoder errors
// pass through). C is the pipeline's channel count: stereo pipelines
// accept stereo CELT packets only (SILK/hybrid packets are mono-coded;
// a stereo pipeline duplicates their up-resampled output).
int opus_host_decode_plan(void* celt_st, void* silk_st, void* silk_side,
                          int32_t* sst, const uint8_t* pkt,
                          int len, int C, int disable_inv, void** arrs,
                          int S, int s, int16_t* silk16, int32_t* mode_out,
                          int32_t* fs_out, int32_t* stereo_out,
                          float* sparams_f = nullptr,
                          int32_t* sparams_i = nullptr) {
  if (!pkt || len < 1) return -1;
  int toc = pkt[0];
  int config = toc >> 3;
  int stereo_pkt = (toc >> 2) & 1;
  int code = toc & 3;
  if (code != 0) return -10;  // single-frame packets only on this path
  const uint8_t* pay = pkt + 1;
  int plen = len - 1;
  memset(silk16, 0, (C == 2 ? 640 : 320) * sizeof(int16_t));
  *fs_out = 16;
  *stereo_out = 0;

  if (config >= 16) {  // CELT-only: configs 16..31
    static const int kEnds[4] = {13, 17, 19, 21};
    if ((config & 3) != 3) return -11;  // 20 ms only
    if (stereo_pkt != (C == 2)) return -14;
    int end = kEnds[(config - 16) >> 2];
    *mode_out = 0;
    return celt_host_decode_plan(celt_st, pay, plen, 960, C, 0, end,
                                 disable_inv, arrs, S, s);
  }
  if (stereo_pkt && C == 2 && config < 12) {
    // stereo SILK: joint mid/side decode + MS->LR (silk_host.cpp
    // silk_host_decode_stereo; reference dec_api.rs n_channels=2)
    if ((config & 3) != 1) return -11;  // 20 ms only on this path
    int fs = config < 4 ? 8 : (config < 8 ? 12 : 16);
    int n = silk_host_decode_stereo(silk_st, silk_side, sst, pay, plen, fs,
                                    20, silk16, silk16 + 320, nullptr);
    if (n < 0) return n;
    sst[7] = 1;  // stream has live stereo-SILK state (PLC routing)
    *mode_out = 1;
    *fs_out = fs;
    *stereo_out = 1;
    return 0;
  }
  if (stereo_pkt && C == 2 && config >= 12) {
    // stereo hybrid: joint mid/side WB SILK decode + stereo CELT resume
    // on the same range decoder (reference decode_frame topology;
    // round-5 addition — previously a per-stream fallback)
    if ((config & 1) != 1) return -11;  // 20 ms only
    int end = config < 14 ? 19 : 21;
    uint32_t ec[10];
    int n = silk_host_decode_stereo(silk_st, silk_side, sst, pay, plen, 16,
                                    20, silk16, silk16 + 320, ec);
    if (n < 0) return n;
    sst[7] = 1;
    int32_t red[3];
    int elen = celt_host_hybrid_redundancy(ec, pay, plen, red);
    if (elen <= 0) return -13;
    *mode_out = 2;
    *fs_out = 16;
    *stereo_out = 1;
    return celt_host_decode_plan_resume(celt_st, pay, elen, 960, C, 17, end,
                                        disable_inv, arrs, S, s, ec);
  }
  if (stereo_pkt) return -14;  // stereo packet in a mono pipeline
  if (config >= 12) {  // hybrid: 12/13 SWB, 14/15 FB (odd = 20 ms)
    if ((config & 1) != 1) return -11;
    int end = config < 14 ? 19 : 21;
    uint32_t ec[10];
    int n = silk_host_decode_ec(silk_st, pay, plen, 16, 20, silk16, ec);
    if (n < 0) return n;
    if (C == 2) memcpy(silk16 + 320, silk16, 320 * sizeof(int16_t));
    // redundancy signaling sits between the SILK and CELT halves; the
    // redundant CELT audio itself (transition smoothing) is skipped on
    // this steady-state path
    int32_t red[3];
    int elen = celt_host_hybrid_redundancy(ec, pay, plen, red);
    if (elen <= 0) return -13;
    *mode_out = 2;
    if (C == 2) {
      // mono hybrid packet in a stereo pipeline: the CELT half is coded
      // MONO, which cannot land in the C=2 plan arena layout — run the
      // exact direct decoder (C=1, resumed range decoder) and duplicate
      // its unit-norm spectrum into both x_direct channels; the plan
      // flag planes for this stream are cleared so only x_direct plays
      celt_host_plan_clear_stream(arrs, s);
      float* xd = (float*)arrs[21] + (size_t)s * 2 * 960;
      double* ble = (double*)arrs[22] + (size_t)s * 42;
      int32_t* ifl = (int32_t*)arrs[23] + (size_t)s * 4;
      double* pg = (double*)arrs[24] + s;
      float tmp[960];
      int rc = celt_host_decode_resume(celt_st, pay, elen, 960, 1, 17, end,
                                       disable_inv, tmp, ble, ifl, pg, ec);
      if (rc < 0) return rc;
      ((uint8_t*)arrs[0])[s] = 1;  // direct fallback flag
      memcpy(xd, tmp, 960 * sizeof(float));
      memcpy(xd + 960, tmp, 960 * sizeof(float));
      float* ble32 = (float*)arrs[26] + (size_t)s * 42;
      for (int i = 0; i < 42; i++) ble32[i] = (float)ble[i];
      ((float*)arrs[27])[s] = (float)pg[0];
      return 0;
    }
    return celt_host_decode_plan_resume(celt_st, pay, elen, 960, C, 17, end,
                                        disable_inv, arrs, S, s, ec);
  }
  // SILK-only: configs 0..11 (NB/MB/WB x 10/20/40/60 ms)
  if ((config & 3) != 1) return -11;  // 20 ms only
  int fs = config < 4 ? 8 : (config < 8 ? 12 : 16);
  if (sparams_f && fs == 16 && C == 1) {
    // device-synthesis opt-in (OpusStreamPipeline silk_synthesis=
    // "device"): symbol-only decode emitting SilkFrameParams planes;
    // the LTP/LPC core synthesis runs on device fused with the mixed
    // step (ops/silk_synthesis_jax.py). Mono WB 20 ms scope; NB/MB
    // and hybrid keep the host PCM path (masked per stream).
    float* fp = sparams_f + (size_t)s * kSilkParamF;
    int32_t* ip = sparams_i + (size_t)s * kSilkParamI;
    int n = silk_host_decode_symbols(silk_st, pay, plen, fs,
                                     fp,             // exc 320
                                     fp + 320,       // a 2*16
                                     fp + 352,       // b 4*5
                                     ip,             // pitch 4
                                     fp + 372,       // gains 4
                                     ip + 4,         // iflags 3
                                     fp + 376);      // ltp_scale
    if (n < 0) return n;
    *mode_out = 5;  // SILK, params on the wire (device synthesis)
    *fs_out = fs;
    return 0;
  }
  int n = silk_host_decode_ec(silk_st, pay, plen, fs, 20, silk16, nullptr);
  if (n < 0) return n;
  if (C == 2) memcpy(silk16 + 320, silk16, 320 * sizeof(int16_t));
  *mode_out = 1;
  *fs_out = fs;
  return 0;
}

// Batched variant: arrs is the 28-pointer CELT plan table (rcs at [25]);
// silk16_all is (S, 320) int16; modes is (S,) int32.
void opus_host_decode_plan_batch(void** celt_states, void** silk_states,
                                 void** silk_sides, int32_t* ssts,
                                 const uint8_t* blob, const int32_t* offs,
                                 const int32_t* lens, int S, int C,
                                 int disable_inv, void** arrs,
                                 int16_t* silk16_all, int32_t* modes,
                                 int32_t* silk_fs, int32_t* silk_stereo,
                                 const uint8_t* fec_blob,
                                 const int32_t* fec_offs,
                                 const int32_t* fec_lens, int n_threads,
                                 float* sparams_f, int32_t* sparams_i) {
  int32_t* rcs = (int32_t*)arrs[25];
  int plane = C == 2 ? 640 : 320;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, S);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= S) break;
      int32_t* sst = ssts ? ssts + (size_t)s * 8 : nullptr;
      void* side = silk_sides ? silk_sides[s] : nullptr;
      silk_stereo[s] = 0;
      if (lens[s] < 0) {
        // feeder skip: this tick's 20 ms comes from a buffered chunk of a
        // 40/60 ms SILK packet the caller already decoded
        // (silk_host_decode); the caller fills silk16/silk_fs after this
        // returns. No state touches here.
        memset(silk16_all + (size_t)s * plane, 0, plane * sizeof(int16_t));
        silk_fs[s] = 16;
        modes[s] = 1;
        rcs[s] = 0;
        continue;
      }
      if (lens[s] == 0) {
        int16_t* sp = silk16_all + (size_t)s * plane;
        memset(sp, 0, plane * sizeof(int16_t));
        // LBRR routing first: the caller may supply the NEXT packet,
        // whose in-band FEC replaces the lost SILK/hybrid frame
        if (fec_lens && fec_lens[s] > 0) {
          int fs = try_lbrr(silk_states[s], fec_blob + fec_offs[s],
                            fec_lens[s], sp);
          if (fs > 0) {
            if (C == 2) memcpy(sp + 320, sp, 320 * sizeof(int16_t));
            silk_fs[s] = fs;
            modes[s] = 4;  // FEC-recovered
            rcs[s] = 2;
            continue;
          }
          memset(sp, 0, plane * sizeof(int16_t));
        }
        // lost frame: CELT PLC runs on device (the caller's lost mask);
        // the SILK half conceals here (int-exact plc.rs/cng.rs twins)
        celt_host_note_loss(celt_states[s]);
        int n;
        if (sst && sst[7]) {  // live stereo-SILK stream: joint PLC
          n = silk_host_plc_stereo(silk_states[s], side, sst, sp, sp + 320);
          silk_stereo[s] = 1;
        } else {
          n = silk_host_plc(silk_states[s], sp);
          if (C == 2) memcpy(sp + 320, sp, 320 * sizeof(int16_t));
        }
        silk_fs[s] = n > 0 ? n / 20 : 16;
        modes[s] = 3;  // lost
        rcs[s] = 1;
        continue;
      }
      rcs[s] = opus_host_decode_plan(celt_states[s], silk_states[s], side,
                                     sst, blob + offs[s], lens[s], C,
                                     disable_inv, arrs, S, s,
                                     silk16_all + (size_t)s * plane,
                                     modes + s, silk_fs + s,
                                     silk_stereo + s, sparams_f,
                                     sparams_i);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
