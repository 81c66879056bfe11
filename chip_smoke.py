"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Drives mousiki_tpu_torch's stream decoders and encoders end to end on the
card: the plan-mode CELT decoder (48 kHz stereo, 20 ms frames), the mixed
SILK / CELT / hybrid decoder (mono), the CELT encoder (device front +
native symbol encoder), the SILK encoder (host analysis + batched
device quantizer), the neural loss recovery (RDOVAE decode, PitchDNN +
FARGAN concealment, the DRED encoder), the CELT decoder with its Python
host and the single-stream API (OpusDecoder with deep PLC and DRED
decode), with the JAX package nowhere in the process (it fails first
thing if any module of mousiki_tpu is loaded):

  1. device check: a CUDA device, its name and power limit (nvidia-smi);
  2. build, all at once: the three native host libraries (csrc/*.cpp,
     g++: celt_host, silk_host, opus_host), the fused de-emphasis kernel
     (csrc/deemphasis.cu, nvcc), the PVQ leaf stage and walk kernels
     (csrc/pvq_leaves.cu), the band assembly kernel
     (csrc/band_assembly.cu), the comb filter kernel
     (csrc/comb_filter.cu), the concealment's row kernel
     (csrc/plc_rows.cu), the two SILK quantizer kernels
     (csrc/silk_nsq.cu), the device SILK synthesis kernel
     (csrc/silk_synthesis.cu) and the neural recovery's two kernels
     (csrc/fargan.cu, csrc/rdovae.cu), each source with its build time,
     and ptxas's report on the quantizers', the synthesis kernel's and
     the neural kernels' registers, stack, spills and shared memory from
     compiles of their own;
  3. kernel vs plain: deemphasis_pcm against deemphasis_pcm_reference on
     the card at (S, C, N) = (256, 2, 960) and (256, 1, 960), the shapes
     the CELT and the mixed main path give it, (32, 2, 960), the
     Python-host CELT path's (phase 19), (1024, 2, 960) and (8, 2, 960),
     the bench's second batch and gate (phase 25), (3, 2, 960), the
     encode quality chain's decode (phase 13b), and (256, 2, 120),
     (7, 1, 960), (3, 2, 240), and a shard's shapes on the mesh of
     phase 23 ((128, 2, 960) and (128, 1, 960) on one card); bar
     1e-4 * max|pcm|. For
     each: the kernel's device time (torch.profiler; input in L2 as on the
     main path, and L2 evicted by a 128 MB read before each launch), its
     HBM bound and bound share, the plain
     version's device time, both per-call CUDA-event times, and a copy
     floor (one out.copy_(x.transpose(1, 2)) moving the same bytes: a
     yardstick that does not compute the same function);
 3b. the PVQ leaf kernels (ops/pvq_leaves.py: leaf_stage, the executor's
     walk, normalisation, spreading rotation and placement of every leaf
     in the X plane, one launch a step; cwrs_walk, the walk alone, the
     lockstep plan emission's) against their plain versions on the card:
     the stage on the golden stereo plans at S = 256 under the serving
     profile (frames 0, 4 and 11), the mixed path's own mono plans
     (frames 0 and 4), a tight profile's plan ((60, 20, 2), 2, 8: some
     streams fall back to the direct decoder) and a plan of seeded
     synthetic leaves of all three tiers (leaf_cases.synthetic_plan:
     every (n, k) with V(n, k) < 2^32, idx at 0, V - 1 and between,
     every spread, b in {1, 2, 4, 8} where it divides n, inactive
     leaves, spans laid across the plane and cut at both of its edges)
     and a plan of leaves past kmax(n) (leaf_cases.outside_leaves: the
     kernels' descent over the full table): each tier's pulse vectors
     exactly equal to the plain walk (through the kernel's pulse
     output), X within 1e-5, exactly 0.0 where no leaf writes, and the
     same X on planes whose streams lie further apart; the walk on every
     tier of the golden frames and on each tier's synthetic and outside
     leaves, iy exactly equal; then the device time
     (torch.profiler) of the walk on each synthetic tier, of the stage on
     the synthetic plan and on its tier 2 alone, and of the stage at
     every (S, C) a path runs it (S = 256, 1024, 8, 3 and a mesh shard's,
     stereo; 256 and a shard's, mono), each beside its bound (the bytes
     it must move over HBM bandwidth: the planes read once, the U-table
     entries its leaves read counted once, X written once where the
     kernel writes it, against integer and float operations over the
     fp32 peak), the plain version's device time and CUDA-event times of
     a call of both;
 3c. the decode step's band assembly (ops/band_assembly.py, P3 of the
     executor, one launch a step) and comb filter
     (ops/synthesis.comb_filter_batched, two launches a step) against
     their plain versions on the card: (a) the band assembly on the
     executor calls of CeltStreamPipeline(256, use_plan=True) on the
     golden stereo streams under the serving profile (frames 0, 4 and
     11: the anti-collapse, noise fills) and of OpusStreamPipeline(256,
     channels=1) on the mono mix (frames 0 and 4), on the direct fallback
     of a tight profile ((60, 20, 2), 2, 8), and on plans of 2.5, 5 and
     10 ms frames (LM 0-2: the n1 sign path, the N = 2 butterfly),
     stereo and mono, encoded on the card by CeltEncodePipeline from the
     golden PCM, and on golden frame 4 with each live fold call's
     source window moved onto a later band's norm region (that band
     forced into the kernel's ordered pass): the X plane within 1e-12
     (the largest error, the values whose float32 rounding differs and
     each plan's bands in the parallel and the ordered pass printed);
     (b) the comb filter on those steps' decode memory and on seeded rows
     (comb_cases.comb_rows: periods 15-1022, tapsets 0-2, the same
     filter before and after, g1 = 0, g0 = g1 = 0, and min(t0, t1) at
     the edges of the kernel's chunk: 15, 33-35, 130-131, 1022, one
     period short) at every frame size, both calls of a frame: each row
     within 4 float32 ulps of its peak magnitude, skipped rows and the
     samples after the blend where g1 = 0 bit for bit; the distribution
     of min(t0, t1) over the golden and the bench's rows printed; (c) at
     every path's (S, C), each kernel's device time of a step's launches
     (torch.profiler), its bound (the bytes the launch must move, the
     operator blocks its calls read counted once by their nonzeros, over
     HBM bandwidth, against float64 operations (2 a nonzero a call) over
     the FP64 peak for the band assembly, float32 operations over the
     fp32 peak for the comb filter; the band bound of the dense count,
     2 n_b^2 a call and whole blocks read, printed beside it), the plain
     version's device time and CUDA-event times of a call of both; the
     lockstep steps' own calls are checked and timed in
     phases 22 and 26; at the end, every frame size a path's executor
     ran is among those checked here (no path of this script runs LM
     0-2);
 3d. the concealment's row kernel (ops/plc.plc_rows: LPC fit, residual,
     decay and excitation, the 1,080-step LPC synthesis, one launch a
     lossy step) against its plain version on the card: the calls of
     CeltStreamPipeline(256, use_plan=True) and of
     OpusStreamPipeline(256, channels=1) under phase 5's loss pattern (8
     frames: first and second losses, the 0.8 fade and the carried LPC)
     and the seeded rows of plc_cases.py (white noise, AR(2), an
     all-zero history, a near full-scale one, pitch 100 and 720 with
     2 * pitch > 1024, a synthesis that saturates at +-65536, rows not
     lost; 1,080 and 360 samples): the lost rows' LPC within 1e-4 of the
     plain version (seeded rows) or no further from a float64 Levinson
     fit than the plain version plus 1e-4 (real histories), ext within
     1e-3 of each row's peak, the rows of streams not lost exactly 0.0
     with the carried LPC; celt_plc_freq through the kernel within 1e-3 *
     max|freq| of its plain route on the lost streams; the worst errors
     and the rows whose float32 LPC or ext bits differ printed; then the
     kernel's device time (torch.profiler) at every (S, C) a lossy path
     runs it (256 and 1024, stereo and mono, a mesh shard's) with ~10% of
     the streams lost, at (256, 2) with all lost, and of one row alone
     (the chain, and its ns a synthesis step), each beside its bound (the
     bytes it must move: planes, the lost rows' history, carried LPCs,
     outputs, over HBM bandwidth, against its operations over the FP64
     peak) and the plain version's device time;
 3e. the SILK quantizer kernels (ops/silk_nsq.nsq_frame and
     nsq_del_dec_frame, one launch a quantizer call) against their plain
     versions on the card, at S = 256 on the quantizer calls of a real
     encoder run (nsq_cases.py) tiled over the lanes, every 17th lane
     unused (the executor's defaults): the share of equal pulses a lane
     >= 0.985 (single state), mean >= 0.9 and half the lanes exactly
     equal (delayed decision), the unused lanes and 8 lanes whose states
     tie at every sample exactly equal (pulses and seed_used), lanes that
     hold the same call equal to each other, and every output equal to
     the host build of the kernels' arithmetic (csrc/silk_nsq.h, g++);
     the same at every other width of NSQ_WIDTHS (the delayed decision
     at 8, 2 and 1, the widths of phases 13 and 13b; the single state at
     1, its chain alone), each lane equal to the S = 256 lane that holds
     its call and held to the plain version; then at each width each
     kernel's time a call by CUDA events, its bound (the bytes of the
     call's inputs and outputs over HBM bandwidth against its float
     operations over the fp32 peak) and share, the time of one sample of
     the chain, the plain version's device time and wall time of one
     call, and the kernel's registers, stack, spills and shared memory as
     ptxas reports them in phase 2;
 3f. the device SILK synthesis kernel (ops/silk_synthesis.
     silk_synthesis_step: gain scale, re-whitening, LTP and LPC of a
     whole frame, one launch a step) against its plain version on the
     card, the output and both state planes within 1e-4 of each frame's
     peak: every call of 12 frames of OpusStreamPipeline(256, channels=1,
     silk_synthesis="device") on the mono mix (the lane's strided views,
     on the same state), of SilkStreamPipeline(256, synthesis="device")
     at 16 and 8 kHz on the golden SILK streams (stream s starting s % 12
     frames in; the plain version carries its own state), and 12 carried
     frames of silk_synthesis_cases.py's seeded 12 kHz streams (voiced and
     unvoiced, interpolation on and off, lags 18 to 216 and per subframe,
     chunks that straddle subframes); the first call of each of these
     and one voiced, interpolated stream alone (the chain) at 16, 12 and
     8 kHz launched 8 times on the same inputs, every launch bit-equal to
     the host build of the kernel's arithmetic (its two warps hand work
     to each other: a race would show as a launch that differs); then
     the kernel's device time (torch.profiler) on each, each beside its
     bound (every parameter and state element read once, the outputs
     written once, over HBM bandwidth, against the float operations these
     streams need over the fp32 peak), the plain version's device time
     and a call's wall time;
 3g. the neural recovery's two kernels (models/fargan.conceal_frames:
     PitchDNN and FARGAN over a call's frames, one launch; models/dred.
     decode_qframes: the RDOVAE decoder over a call's qframes, one launch)
     against their plain versions on the card, on the port's seeded
     models: conceal_frames at S = 64 and 256 on bench.py's features, 5
     calls with the state carried, and DeepPlcState.conceal's route
     (PitchDNN once, two frames) at S = 1; decode_qframes on phase 16's
     DRED payloads and on one stream alone; each call one launch, integer
     periods equal or flipped only within 1e-3 of an integer, PCM and
     state within 1e-4 (features within 1e-4 of their scale), bit-equal to
     the host build of the kernel's arithmetic (every stream, but 8 of
     256 past the first call), a stream bit-equal alone at S = 1; then
     each call's kernel device time (torch.profiler and CUDA events)
     beside its bound (the weights, inputs and state read once, outputs
     written once over HBM bandwidth, against 2 operations a weight a row
     applied over the fp32 peak), the plain version's device time and
     both calls' wall time; ptxas's report of both kernels in phase 2;
  4. main path: CeltStreamPipeline(256, channels=2, use_plan=True) with the
     serving plan profile; stream s plays golden stereo stream s % 3 for
     12 frames; every stream within 2e-4 of the golden PCM, and the kernel
     launched once a step by the path itself (launch counts reset just
     before), the leaf stage kernel and the band assembly kernel once
     and the comb filter kernel twice a step, the walk kernel never (on
     this and every other plan path below: phases 7, 13b, 22, 23, 25 and
     26's lockstep probe, where the plan emission launches the walk at
     most once a tier a step; the comb filter alone on the non-plan
     paths of phases 19 and 26's batch decode);
  5. loss: 256 streams with ~10% seeded packet loss, the first 8 streams
     against the port run on the CPU (5e-3 on lost and just-recovered
     frames, 2e-4 elsewhere); the batch check: the same 256 streams as
     the first 256 of a batch of 1024 (the other 768 with their own
     loss) within 1e-5 on every lane, and 16 streams with 30% loss from
     frame 2 as one batch, as 8 batches of 2 and as 5 + 11, 4 frames,
     every lane within 1e-5 and each stage of the step compared
     (batch_stages.py: the worst error a stage and the first stage that
     differs are printed); the concealment's row kernel launched once in
     each lossy step at S = 256 and 1024 (from phase 4 on, every plan
     step on the card is held to one launch where the host saw a lost
     stream and none where it saw none, and the plain LPC synthesis
     never runs on the card);
  6. the CELT decoder's other modes at S = 256, 8 frames:
     decode_frames_scanned, decode_stream(chunk=4) and decode_stream with
     overlap_host each equal to the stepped output exactly, and the
     non-plan path within 2e-4 of the golden PCM;
  7. mixed main path: OpusStreamPipeline(256, channels=1); stream s plays
     golden mono stream s % 5 (CELT, SILK 16 kHz, SILK 8 kHz, two hybrid),
     whole packets, 12 frames; every stream within 2e-4 of the golden PCM
     (hybrid_fb_48k from frame 2 on), modes 0, 1 and 2 all present, the
     kernel launched once a step (counts reset just before);
  8. device SILK: SilkStreamPipeline(256, synthesis="device") against
     synthesis="host" on the SILK 16 kHz payloads, SNR above 45 dB; and
     the device-SILK lane of the mixed decoder within 5e-3 of its host
     lane; the SILK synthesis kernel launched once a step on both (counts
     reset just before each);
  9. mixed loss: ~10% seeded loss on the mono mix, the first 8 streams
     against the port run on the CPU (5e-3 / 2e-4 as in phase 5), and
     the batch check of phase 5 (16 streams with 15% loss from frame 1,
     3 frames); the row kernel once a lossy step, as in phase 5;
 10. encode front: ops/encode_front.front_step at S = 256, stereo, on the
     golden stereo PCM (stream s replays fixture s % 3), 12 frames with
     the state threaded, against the same function on the CPU: every
     integer and boolean output equal, freq within 1e-4 * max|freq|, the
     float outputs within 1e-4;
 11. CELT encode (the encode side's main path): CeltEncodePipeline(256,
     channels=2, bitrate=128000), the 12 golden frames through step() and
     again through encode_stream() with chunks of 4; every packet
     non-empty; the packets decoded by CeltStreamPipeline on the card and
     held to the input by a band-limited SNR (16 kHz mono downmix, best
     delay), the bar 3 dB under the SNR of the same round trip through the
     port on the CPU in the same run (both printed); the share of packets
     byte-equal to the CPU port's is printed;
 12. SILK quantizers: nsq_frame and nsq_del_dec_frame at S = 256 against
     the CPU port, lanes tiled from the quantizer calls of a real encoder
     run (the copied host encoder on a seeded speech-like signal): share
     of equal pulses a lane >= 0.985 (single state); mean >= 0.9 and half
     the lanes exactly equal (delayed decision); lanes that hold the same
     call give the same pulses; each kernel launched once a call; at the
     first sample of the delayed decision, state 0 wins in the lanes where
     all states tie (the plain version on the card, whose torch.argmin
     is watched), and on those lanes the kernel's pulses and seed_used
     equal the plain version's;
 13. SILK encode: SilkEncodePipeline(8) for 4 frames at 24 kbit/s on the
     golden mono PCM; stream 0's packets equal a one-stream pipeline's,
     every packet decodes in OpusStreamPipeline to finite PCM, and the
     delayed-decision kernel is launched once a device quantizer call
     (the executors' dispatches);
 13b. encode quality (mousiki_tpu_torch/quality.py, the chain of
     tools/torch_celt_quality_report.py and torch_silk_quality_report.py,
     against testdata/encode_quality_fixture.npz: the CPU port's packets
     and libopus's side, made where libopus is): testdata/corpus.wav
     (200 frames) encoded on the card at 64, 96 and 128 kbit/s, decoded
     on the card by CeltStreamPipeline(3, use_plan=True) in one scanned
     dispatch (one stream a rate; the kernel launched once a frame, counts
     reset just before) and scored with opus_compare against the corpus,
     err4 and err16 within 0.005 of the fixture's libopus-decoded score
     of the CPU port's packets; the 24 and 32 kbit/s SILK lanes of one
     SilkEncodePipeline over the first 16 frames of the speech corpus,
     every lane held by the device quantizer, decoded on the card by
     OpusStreamPipeline(2, channels=1), each lane's SNR to the input at
     least the fixture's (libopus's decode of the CPU port's packets)
     less 3 dB, the kernel launched once a device quantizer call; the
     share of packets equal to the fixture's printed;
 14. timing: steady-state ms/step and aggregate realtime-x through
     decode_stream: the CELT decoder at S = 256 (default, overlap_host,
     chunk=4) and S = 1024, the mixed decoder at S = 256 and S = 1024,
     8 steps after warm-up, each timed three times (once at S = 1024), the
     modes of one width taking turns (every run, the least and the median
     are reported); the
     CELT encoder at
     S = 256 through step() and through encode_stream() with chunks of 8
     (24 frames after 8 of warm-up, three runs in turn); and profiled
     steps (kernel launches, the leaf kernels' among them, device busy
     time, host time by stage) of both decoders, the device-SILK lane
     (also timed with the mixed decoder, in turns) and
     SilkStreamPipeline(256, synthesis="device") (each one
     silk_synthesis launch, none in spans silk.ltp and silk.lpc; the
     lane's step within 700 launches),
     one encode step and one executor dispatch of each quantizer at
     S = 256 (its nsq.h2d / nsq.quantize / nsq.d2h spans; one kernel
     launch, at most 5 launches in nsq.quantize); the CELT step at
     S = 256 within 700 launches and the mixed step within 700, and one
     lossy CELT and one lossy mixed step (every tenth stream lost) within
     600 each, the row kernel launched once in each;
 15. neural concealment: BatchedDeepRecovery(64) with the port's seeded
     synthetic models, 5 conceal calls of 2 frames on bench.py's features
     (default_rng(0), (64, 2, 20) * 0.3), against the same class on the
     CPU in this run: every PitchDNN period within 1e-3 of the CPU's, an
     integer period that differs (a flip) accepted only where the CPU's
     float lies within 1e-3 of an integer (each flip printed), the PCM
     within 1e-4 in every lane without a flip, all finite; the
     concealment kernel launched once a call (counts reset just before);
 16. RDOVAE decode: process() at S = 64 on DRED payloads (dred_encode of
     seeded latents, 26 a stream, synthetic stats, several levels) against
     the CPU port within 1e-4 * max|features|, and two rows against the
     per-stream opus_dred_process on the card; the RDOVAE kernel launched
     once by process and once by each opus_dred_process;
 17. DRED encode: the copied OpusEncoder(48000, 1) at 24 kbit/s with
     set_dred_duration(40), its RDOVAE encoder on the card (the default:
     no model given), 2 streams x 10 frames; DRED parses from at least 8
     packets a stream, every packet (its padding removed: the native host
     stage takes single-frame packets) decodes to finite PCM in
     OpusStreamPipeline on the card, and the share of packets byte-equal to
     the CPU port's is printed;
 18. neural timing: dred_recovery_x_s64 as bench.py's bench_deep_recovery
     defines it (S = 64, 2 frames a call, 10 calls a window, the median of
     the windows; 3 windows here, not 6, to save time), the same at
     S = 256, the ms of a process call at S = 64 (median of 3), one
     profiled conceal call at each width and one profiled process call;
     the kernel launched once a call in each (counts reset just before),
     at most 10 launches in a profiled call at S = 64;
 19. Python-host CELT: CeltStreamPipeline(32, 2, use_native=False), one
     copied Python CeltDecoder a stream in front of the device synthesis,
     stream s playing golden stereo stream s % 3 for 12 frames; every
     stream within 2e-4 of the golden PCM, the kernel launched once a step
     by the path itself (counts reset just before), the ms a step;
 20. single-stream API (host numpy code, no libopus): the port's
     OpusDecoder over all 8 golden streams (96 packets), every final range
     equal to the fixture's and the PCM within 2e-4 of the golden PCM;
     codec.Decoder equal to OpusDecoder on one stream; a 5.1
     MultistreamEncoder.surround -> MultistreamDecoder round trip on a
     seeded signal, finite; an OggOpusWriter -> OpusFile round trip of one
     golden stream, packets equal;
 21. deep PLC and DRED decode on the card: the port's OpusDecoder(48000, 1)
     with set_deep_plc on the port's seeded FARGAN and PitchDNN and
     set_dred_models on its seeded RDOVAE decoder, on the card and on the
     CPU side by side, over the DRED packets of the copied OpusEncoder
     (as phase 17): 8 good packets, 2 lost and decoded from the DRED of
     the next one (dred_parse, dred_process, dred_decode), that packet,
     one more lost frame concealed without DRED; features and PCM within
     1e-4 of the CPU's, each pitch period flip printed and excused only
     within 1e-3 of an integer; the launches of one deep-PLC
     decode(None, 960); the RDOVAE kernel launched once (dred_process) and
     the concealment kernel once a concealed frame;
 22. the lockstep decoder (ops/celt_lockstep_top.lockstep_synthesis_step:
     symbol stages, band-tree walk, plan emission, executor and synthesis,
     all on the card; the host only pads the packets): S = 256 stereo
     lanes (stream s plays golden stereo stream s % 3) and S = 256 mono
     lanes of celt_fb_mono_64k, state carried from frame 0, 2 frames of
     each; every lane ok, PCM within 2e-4 of the golden PCM, the kernel
     launched once a step (counts reset just before); ms a step, the host
     time of each stage of the first step, and one profiled step
     (device-only trace: kernels, device busy time) of each width; the
     plan emission's three walk launches of the first step (its (S x CAP)
     planes, kept as it ran) again through the walk kernel, iy equal to
     the plain walk, and timed as in phase 3b, and the first step's leaf
     stage, band assembly and comb filter calls through their kernels
     against the plain versions and timed as in phases 3b and 3c (the
     same for the lockstep probe of phase 26);
 23. the stream mesh (parallel/streaming.py): every card when there are
     two or more, else two shards on the one card
     (shards_on_one_card=true). CeltStreamPipeline(256, 2, mesh=...,
     use_plan=True) on the stereo fixtures (12 frames) and
     OpusStreamPipeline(256, mesh=...) on the mono mix (6 frames), ~10%
     seeded loss from frame 2, each against a single-device pipeline fed
     the same frames: 1e-5 on every lane (the worst on the streams that
     have lost nothing yet and on the others printed apart), the streams
     that lost nothing within 2e-4 of the
     golden PCM, and one kernel launch a shard a step (counts reset just
     before the mesh run), the row kernel once a lossy shard a step;
     ms/step of the mesh and of the single-device pipeline at S = 256,
     loss-free, taking turns, three runs of 4 steps;
     one profiled mesh step (launches, the gather's launches and host
     time);
 24. libopus: whether the host has it (hostcodec/testing/oracle.py) and
     its version; where it has, the plan pipeline on the three stereo
     fixtures within 2e-4 of libopus's float decode; where it has not,
     the line libopus=unavailable (a fact about the host, not a failure);
 25. the bench (mousiki_tpu_torch/bench.py, bench_torch.py's): its quick
     run at S = 256 with the second batch at S = 1024, on the committed
     libopus fixture (testdata/bench_fixture.npz); its JSON line printed,
     the quality gate passed on the synthetic signal and the corpus
     (first 16 frames each), every value finite; then the kernel launched
     once a step in an e2e window at S = 256 and at S = 1024, and once a
     frame in the gate's scanned decode at (8, 2, 960) (counts reset just
     before each).
 26. entry points: the twins of the JAX repo's examples and tools
     (examples/torch_*.py, tools/torch_*.py), each through its function
     on the card: batch decode (CeltStreamPipeline(8), the reference's
     non-plan default, 25 frames; the kernel launched once a step, counts
     reset just before; PCM finite and within 2e-4 of
     CeltStreamPipeline(8, use_plan=True) on the same payloads); DRED
     recovery (25 frames, 12-13 lost, every network on the card; the gap
     recovered through DRED; every PitchDNN period within 1e-3 of the
     CPU's; PCM within 1e-4 of the CPU decode of the same packets with
     the same weights, where a period flip (excused only within 1e-3 of
     an integer) leaves the bar on the frames before the loss; the share
     of packets equal to the twin's CPU run printed); once each, as smoke
     runs of host code: the single-stream chain (write an .opus, decode
     it, seek in it; the trivial round trip), codec_bench (packets,
     encode, decode; 10 frames, --warmup 0 --measure 1) and
     opus_packet_tool, their lines and files checked for form, and
     build_dnn_blob on a synthetic C source; the
     lockstep probe at S = 256, one step and one trial of one step (the
     kernel launched once a step, counts reset just before), every lane
     ok, the first step's PCM within 2e-4 of CeltStreamPipeline(256,
     use_plan=True) on the same packets; the seconds of each part.

Any failure raises (exit code != 0). Lines before the last report each
phase; the line before the last is the kernel table as JSON (one row for
each path's shape, every number of a row measured at that shape, the
device time with the input in L2 as the path leaves it and with L2
evicted; for the walk, one row for each lockstep path, its numbers those
of a step's three launches in the plan emission; for the leaf stage, the
band assembly and the comb filter, one row for each path that runs them,
a step's launches at the path's width, or the lockstep step's own; for
the concealment's rows, one row for each lossy path and width, its
launches beside phase 3d's times at that width, with chain_ms the time
of one row alone; for the quantizers, one row for each path that runs
them (phases 12, 13 and 13b), its launches beside phase 3e's times at
S = 256; for the SILK synthesis, one row for each device-SILK path of
phase 8, its launches beside phase 3f's times on that path's calls; for
the neural kernels, one row for each path of phases 15, 16, 18 and 21
that runs one, its launches beside phase 3g's times of a call of that
shape); the last line is {"ok": true, "device": {...}}. The "run" line holds the wall
seconds of every phase. With --out DIR, everything
measured also goes to DIR/chip_smoke.json, and the profiler's tables of
the profiled steps to DIR/profile_*.txt.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

import batch_stages
from golden_streams import (MIX_GOLDEN_FROM, frame_batch, golden_pcm,
                            load_mono_mix, load_stereo_celt)
from comb_cases import comb_calls, comb_rows
import nsq_cases
import plc_cases
import silk_synthesis_cases
from leaf_cases import outside_leaves, synthetic_leaves, synthetic_plan
from mousiki_tpu_torch._device import operator64, require_cuda
from mousiki_tpu_torch.ops import _build
from mousiki_tpu_torch.ops import band_assembly as band_asm
from mousiki_tpu_torch.ops import deemphasis as deemph
from mousiki_tpu_torch.ops import pvq_leaves as pvq
from mousiki_tpu_torch.ops._tables import U_K, U_N, plan_combo_mats_np
from mousiki_tpu_torch import bench, dred, quality
from mousiki_tpu_torch.hostcodec.bitstream.repacketizer import \
    opus_packet_unpad
from mousiki_tpu_torch.hostcodec.opus_encoder import OpusEncoder
from mousiki_tpu_torch.models import deep_plc, fargan
from mousiki_tpu_torch.models import dred as rdovae
from mousiki_tpu_torch.ops import celt_lockstep_emit as lockstep_emit
from mousiki_tpu_torch.ops import celt_lockstep_top as lockstep
from mousiki_tpu_torch.ops import encode_front, plc, silk_nsq, synthesis
from mousiki_tpu_torch.ops import silk_synthesis as silk_syn
import mousiki_tpu_torch.pipeline as pipeline_mod
from mousiki_tpu_torch.hostcodec.testing import oracle
from mousiki_tpu_torch.celt.host_native import NativeCeltHostBatch
from mousiki_tpu_torch.celt.plan import TIERS
from mousiki_tpu_torch.ops import band_exec
from mousiki_tpu_torch.ops.band_exec import plan_combo_mats
from mousiki_tpu_torch.parallel.deep_recovery import BatchedDeepRecovery
from mousiki_tpu_torch.parallel.streaming import StreamMesh, make_mesh
from mousiki_tpu_torch.pipeline import (SERVING_PROFILE, CeltEncodePipeline,
                                        CeltStreamPipeline,
                                        OpusStreamPipeline,
                                        SilkEncodePipeline,
                                        SilkStreamPipeline, set_plan_profile)
from mousiki_tpu_torch.repo_files import load_script

FRAME = 960
GOLDEN_TOL = 2e-4
KERNEL_REL_TOL = 1e-4
# NVIDIA H100 SXM data sheet peaks (dense, no sparsity, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
# float64 (the band assembly's products): the data sheet's FP64 peak, on
# the tensor cores (34e12 outside them, where the kernel runs them); the
# bound is the least time the card could take
FP64_FLOPS = 67e12
S_MAIN, S_WIDE = 256, 1024      # streams of the main paths / the wide timing
S_PYHOST = 32                   # streams of the Python-host CELT path
LOCKSTEP_FRAMES = 2             # frames a width of the lockstep phase
# (S, C, N) of the kernel's input on the CELT and on the mixed main path,
# on the Python-host CELT path, and on the bench's second batch and gate
CELT_SHAPE, MIXED_SHAPE = (S_MAIN, 2, FRAME), (S_MAIN, 1, FRAME)
PYHOST_SHAPE = (S_PYHOST, 2, FRAME)
WIDE_SHAPE, GATE_SHAPE = (S_WIDE, 2, FRAME), (bench.GATE_STREAMS, 2, FRAME)
# and on the encode quality chain's decode, one stream a CELT rate
QUALITY_SHAPE = (len(quality.CELT_RATES), 2, FRAME)
S_EXAMPLE = 8                   # examples/torch_batch_decode.py's default
# the batch decode example's shape; the same as the gate's, so phase 3
# measures it there
EXAMPLE_SHAPE = (S_EXAMPLE, 2, FRAME)
KERNEL_SHAPES = (CELT_SHAPE, MIXED_SHAPE, PYHOST_SHAPE, WIDE_SHAPE,
                 GATE_SHAPE, QUALITY_SHAPE, (256, 2, 120), (7, 1, 960),
                 (3, 2, 240))
BENCH_WINDOW = 4                # steps of phase 25's counted e2e windows
TIMING_REPEATS = 3
TIMING_STEPS = 8                # timed steps a run of phase 14
ENCODE_BITRATE = 128000
# the card's CELT encode -> decode round trip may fall this far (dB) under
# the same round trip through the port on the CPU, made in the same run
ENCODE_SNR_MARGIN_DB = 3.0
# the card's CELT quality chain (encode and decode on the card) against
# the CPU port's packets decoded by libopus: err4 and err16 apart at most
# (the port's decoder is within 2e-4 of libopus's PCM)
QUALITY_TOL = 0.005
# a stream's PCM against the same stream in another batch (the mesh's
# shards, a wider batch, smaller batches): the reference's bar
# (tests/test_sharded_plan.py), on every lane, lost or received
BATCH_TOL = 1e-5
MESH_TIMING_STEPS = 4
F_MIXED_MESH = 6                # frames of the mixed mesh check
# the PVQ leaf kernels against their plain versions: pulse vectors
# exactly equal, X within the X plane's bar of tests/test_band_exec.py and
# tests/test_torch_band_exec.py
LEAF_TOL = 1e-5
LEAF_FRAMES = (0, 4, 11)        # golden frames of the real-leaf check
LEAF_TIMING_FRAME = 4
LEAF_PLANES = ("active", "n", "k", "idx", "gain", "b", "spread", "dst")
# the walk alone, which only the lockstep plan emission launches (three
# a step, one a tier): the reference's loop, the kernel's symbol
LEAF_KERNELS = {
    "cwrs_walk": ("mousiki_tpu/ops/band_exec_jax.py:150",
                  "cwrs_walk_kernel"),
}
# the kernels a decode step launches once (the executor's leaf stage, its
# P3 band assembly) and twice (the comb filter, in its synthesis): the
# reference's loop, the kernel's symbol, the source; the leaf stage
# replaces execute_packed's P1 + P2 block (cwrs_walk :150, rotate_leaves
# :280, the normalisation and the pool -> X gather, :418-456)
STEP_KERNELS = {
    "pvq_leaf_stage": ("mousiki_tpu/ops/band_exec_jax.py:418",
                       "pvq_leaf_stage_kernel",
                       "mousiki_tpu_torch/csrc/pvq_leaves.cu"),
    "band_assembly": ("mousiki_tpu/ops/band_exec_jax.py:514",
                      "band_assembly_kernel",
                      "mousiki_tpu_torch/csrc/band_assembly.cu"),
    "comb_filter": ("mousiki_tpu/ops/synthesis_jax.py:181",
                    "comb_filter_kernel",
                    "mousiki_tpu_torch/csrc/comb_filter.cu"),
}
KERNEL_SYMBOLS = {name: v[1] for name, v in (*LEAF_KERNELS.items(),
                                             *STEP_KERNELS.items())}
# the band assembly against its plain version on the card: both compute
# in float64 op by op and differ only in the order of a product's or a
# sum's terms, so the X plane agrees to float64 round-off (a float32 step
# would miss it by ~1e-8; the plain version's bar against the JAX package
# on the CPU, 1e-5 in tests/test_torch_band_exec.py, is f32 round-off)
ASSEMBLY_TOL = 1e-12
ASSEMBLY_FRAMES = (0, 4, 11)    # golden stereo frames of the check
MIXED_FRAMES = (0, 4)           # mono mix frames of the check
# tests/test_torch_band_exec.py's tight profile: streams whose leaves
# overflow it fall back to the direct decoder
TIGHT_PROFILE = ((60, 20, 2), 2, 8)
SHORT_FRAMES = (120, 240, 480)  # LM 0-2, encoded on the card for 3c
# the comb filter against its plain version: a row within this many
# float32 ulps of its peak magnitude (the sum of a sample's ten taps
# rounds in another order)
COMB_ULPS = 4
# the profiled steps of phase 14 at S = 256, at most (28,448 and 26,002
# before the leaf stage ran as two kernels a tier; 5,112 and 2,666
# before the band assembly and the comb filter did), and the lossy steps
# (a tenth of the streams lost) within 600 (6,431 a CELT step before the
# concealment's row work ran as one kernel)
MAX_STEP_LAUNCHES = {"S256": 700, "mixed_S256": 700, "S256_lossy": 600,
                     "mixed_S256_lossy": 600,
                     # 2,236 before the SILK synthesis ran as one kernel
                     "mixed_S256_device_silk": 700}
PATH_LAUNCHES: dict = {}        # path -> {kernel: launches in its run}
# lockstep path -> {kernel: times of its first step's own call(s)}
OWN_STEP_ROWS: dict = {}
# the _device_ms measurements timed with CUDA events, not the profiler
EVENT_TIMED: list = []
FRAMES_DECODED: set = set()     # frame sizes the paths' executors ran
# lockstep path -> the times of its plan emission's walk launches a step
EMISSION_WALK: dict = {}
# the concealment's row kernel against its plain version: the LPC of a
# well-conditioned row (tests/test_torch_plc.py's bar), a real history's
# no further from the float64 fit than the plain version's plus this; ext
# and the re-entry spectrum relative to a row's (the lost streams')
# largest value (an LPC synthesis over 1,080 samples, in which float32
# round-off grows)
PLC_LPC_TOL = 1e-4
PLC_EXT_TOL = 1e-3
# the reference's loop the row kernel replaces, and its source
PLC_KERNEL = ("mousiki_tpu/ops/plc_jax.py:90",
              "mousiki_tpu_torch/csrc/plc_rows.cu")
# the label the concealment guard files a step's launches under, and
# (label, S, C) -> [steps, lossy steps, plc_rows launches] on the card
PLC_PATH = ["other"]
PLC_LAUNCHES: dict = {}
# the SILK quantizer kernels: the reference's compiled scan each replaces
# and the kernel's symbol; kernel -> {path: launches in the path's run}
NSQ_KERNELS = {
    "nsq_frame": ("mousiki_tpu/ops/silk_nsq_jax.py:262", "nsq_frame_kernel"),
    "nsq_del_dec": ("mousiki_tpu/ops/silk_nsq_jax.py:685",
                    "nsq_del_dec_kernel"),
}
NSQ_SOURCE = "mousiki_tpu_torch/csrc/silk_nsq.cu"
# the widths phase 3e times each kernel at: the paths' (phase 12 and the
# profiles at S = 256; SilkEncodePipeline(8) and its one-stream twin
# (phase 13); the two wide-band lanes of the encode quality chain (phase
# 13b)), and one stream alone, its chain
NSQ_WIDTHS = {"nsq_frame": {S_MAIN, 1}, "nsq_del_dec": {S_MAIN, 8, 1, 2}}
# kernel -> its registers, stack, spills and shared memory as ptxas
# reports them (phase 2)
NSQ_PTXAS: dict = {}
# kernel -> {(path, S): launches in the path's run}
NSQ_LAUNCHES: dict = {name: {} for name in NSQ_KERNELS}
# at most this many launches in a profiled dispatch's nsq.quantize span
NSQ_MAX_QUANTIZE_LAUNCHES = 5
# the device SILK synthesis kernel: the reference's step whose compiled
# loops it replaces, the kernel's symbol, its source; against its plain
# version on the card within this of a frame's peak output, the output
# and both state planes (tests/test_torch_silk_synthesis.py's bar: the
# plain version sums in CUDA's order there, and the LPC filter carries
# the last-bit differences), over 12 frames
SYN_KERNEL = ("mousiki_tpu/ops/silk_synthesis_jax.py:71",
              "silk_synthesis_kernel",
              "mousiki_tpu_torch/csrc/silk_synthesis.cu")
SYN_TOL = 1e-4
SYN_FRAMES = 12
# path of phase 8 -> (the kernel's launches in its run, the row of phase
# 3f that times its calls)
SYN_LAUNCHES: dict = {}
# launches of each of phase 3f's calls on the same inputs, each held
# bit-equal to the host build; the rates of its one-stream calls (the
# chain); the kernel's registers, stack, spills and shared memory as
# ptxas reports them (phase 2)
SYN_REPEATS = 8
SYN_CHAIN_KHZ = (16, 12, 8)
SYN_PTXAS: dict = {}
# the neural recovery's two kernels: the reference's scan each replaces,
# the kernel's symbol, its source
NEURAL_KERNELS = {
    "fargan_conceal": ("mousiki_tpu/parallel/deep_recovery.py:63",
                       "fargan_conceal_kernel",
                       "mousiki_tpu_torch/csrc/fargan.cu"),
    "rdovae_decode": ("mousiki_tpu/parallel/deep_recovery.py:39",
                      "rdovae_decode_kernel",
                      "mousiki_tpu_torch/csrc/rdovae.cu"),
}
NEURAL_CALLS = 5                # carried conceal calls of phase 3g
# streams of a conceal call at S = 256 held to the host build past the
# first call (every stream of the first call and of each call at S = 64)
NEURAL_HOST_STREAMS = 8
# (path, kernel) -> (launches in the path's run, the row of phase 3g that
# times a call of that shape)
NEURAL_LAUNCHES: dict = {}
# a conceal or process call at S = 64 makes at most this many launches
NEURAL_MAX_LAUNCHES = 10
NEURAL_PTXAS: dict = {}
RESULTS: dict = {}
OUT_DIR: str | None = None


def say(phase: str, **fields) -> None:
    RESULTS.setdefault(phase, {}).update(fields)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


# ---------------------------------------------------------------- phases

def check_no_jax_package() -> None:
    """The port runs alone: no module of the JAX package is loaded."""
    loaded = sorted(m for m in sys.modules
                    if m == "mousiki_tpu" or m.startswith("mousiki_tpu."))
    check(not loaded, f"modules of the JAX package are loaded: {loaded}")


def phase_device():
    dev = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        card=repr(card), jax_package_modules=0, jax="jax" in sys.modules)
    return dev, card


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return round(time.perf_counter() - t0, 3)


def _wall_ms(fn) -> float:
    """Host wall ms of one call of `fn`, the card synchronised before and
    after it."""
    return _timed(fn)[1]


def _timed(fn):
    """(the result of one call of `fn`, its host wall ms), the card
    synchronised before and after it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_build():
    """g++ for the three host libraries and nvcc for the nine kernel
    sources, started together."""
    with ThreadPoolExecutor(max_workers=8) as pool:
        hosts = {name: pool.submit(_timed, partial(_build.build_host, name))
                 for name in _build.HOST_LIBS}
        kernel = pool.submit(_timed, deemph.build_kernel)
        leaves = pool.submit(_timed, pvq.build_kernel)
        assembly = pool.submit(_timed, band_asm.build_kernel)
        comb = pool.submit(_timed, synthesis.build_comb_kernel)
        rows = pool.submit(_timed, plc.build_plc_kernel)
        nsq = pool.submit(_timed, silk_nsq.build_kernel)
        nsq_ptxas = pool.submit(_build.ptxas_info, "silk_nsq")
        syn = pool.submit(_timed, silk_syn.build_kernel)
        syn_ptxas = pool.submit(_build.ptxas_info, "silk_synthesis")
        neural = {name: (pool.submit(_timed, build),
                         pool.submit(_build.ptxas_info, name))
                  for name, build in (("fargan", fargan.build_kernel),
                                      ("rdovae", rdovae.build_kernel))}
        say("build", kernel="csrc/deemphasis.cu",
            kernel_seconds=kernel.result(),
            leaf_kernels="csrc/pvq_leaves.cu",
            leaf_kernels_seconds=leaves.result(),
            band_assembly="csrc/band_assembly.cu",
            band_assembly_seconds=assembly.result(),
            comb_filter="csrc/comb_filter.cu",
            comb_filter_seconds=comb.result(),
            plc_rows="csrc/plc_rows.cu", plc_rows_seconds=rows.result(),
            silk_nsq="csrc/silk_nsq.cu", silk_nsq_seconds=nsq.result(),
            silk_nsq_ptxas=_nsq_ptxas(nsq_ptxas.result()),
            silk_synthesis="csrc/silk_synthesis.cu",
            silk_synthesis_seconds=syn.result(),
            silk_synthesis_ptxas=_syn_ptxas(syn_ptxas.result()),
            **{f"{name}_seconds": built.result()
               for name, (built, _) in neural.items()},
            neural_ptxas=_neural_ptxas({name: info.result() for name, (_, info)
                                        in neural.items()}),
            **{f"{name}_seconds": fut.result()
               for name, fut in hosts.items()})


def _nsq_ptxas(entries: dict) -> dict:
    """NSQ_PTXAS from ptxas's report on csrc/silk_nsq.cu (by entry), each
    quantizer kernel found by its symbol; returns it."""
    for name, (_, symbol) in NSQ_KERNELS.items():
        found = [v for k, v in entries.items() if symbol in k]
        check(len(found) == 1, f"ptxas reports no one {symbol}: "
              f"{sorted(entries)}")
        NSQ_PTXAS[name] = found[0]
    return NSQ_PTXAS


def _syn_ptxas(entries: dict) -> dict:
    """SYN_PTXAS from ptxas's report on csrc/silk_synthesis.cu; returns
    it."""
    found = [v for k, v in entries.items() if SYN_KERNEL[1] in k]
    check(len(found) == 1, f"ptxas reports no one {SYN_KERNEL[1]}: "
          f"{sorted(entries)}")
    SYN_PTXAS.update(found[0])
    return SYN_PTXAS


def _neural_ptxas(reports: dict) -> dict:
    """NEURAL_PTXAS from ptxas's reports on csrc/fargan.cu and
    csrc/rdovae.cu (by source), each kernel found by its symbol; returns
    it."""
    for (name, (_, symbol, _)), report in zip(NEURAL_KERNELS.items(),
                                               reports.values()):
        found = [v for k, v in report.items() if symbol in k]
        check(len(found) == 1, f"ptxas reports no one {symbol}: "
              f"{sorted(report)}")
        NEURAL_PTXAS[name] = found[0]
    return NEURAL_PTXAS


def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int = 20, match: str | None = None,
               between=None, device_only: bool = False) -> float:
    """Mean device time a call of `fn`: the summed durations of the CUDA
    kernels it runs (those whose name holds `match`, if given), under
    torch.profiler; apart from the host time between launches that CUDA
    events also count. `between` runs before each call, unmeasured when
    `match` leaves its kernels out. The profiler now and then drops
    kernel events, so the time is the mean kernel duration times the
    kernels a call runs; a window in which it saw under half of them is
    measured again. After three such windows (late in a run, after
    phases of a million launches, it has seen none for six windows in a
    row) the calls are timed with CUDA events instead (_event_ms).
    device_only: trace the card alone, not the host's operators (a
    plain version of thousands of launches a call traces in a fraction
    of the time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for window in range(3):
        activities = [ProfilerActivity.CUDA]
        if not device_only:
            activities.insert(0, ProfilerActivity.CPU)
        with profile(activities=activities) as prof:
            for _ in range(reps):
                if between is not None:
                    between()
                fn()
            torch.cuda.synchronize()
        us = [ev.time_range.elapsed_us() for ev in prof.events()
              if ev.device_type == cuda
              and (match is None or match in ev.name)]
        if len(us) >= max(1, reps // 2):
            per_call = max(1, round(len(us) / reps))
            return sum(us) / len(us) * per_call / 1e3
        print(f"[profiler] window {window}: {len(us)} kernels seen in "
              f"{reps} calls; measuring again", flush=True)
    ms, queued = _event_ms(fn, reps, between)
    print(f"[profiler] timed with CUDA events instead: {ms} ms a call "
          f"(calls queued behind a sleeping card: {queued})", flush=True)
    EVENT_TIMED.append(dict(match=match, ms=ms, queued=queued))
    return ms


def _event_ms(fn, reps: int, between=None) -> tuple[float, bool]:
    """Mean time on the card of a call of `fn` (all of its kernels) by
    CUDA events around each call, the calls queued behind a sleeping
    card so that they run back to back, without the host's gaps; the
    sleep is lengthened until the host has queued every call before the
    card wakes. Returns (ms, queued in time); a `fn` that waits for the
    card never is, and its time then holds the host's gaps."""
    cycles = 1 << 24                    # ~8 ms at the H100's clock
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        woke = torch.cuda.Event()
        woke.record()
        pairs = []
        for _ in range(reps):
            if between is not None:
                between()
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
            fn()
            pairs[-1][1].record()
        queued = not woke.query()
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in pairs) / reps
        if queued:
            break
        cycles *= 8
    return ms, queued


def bound_ms(S: int, C: int, N: int) -> tuple[float, str, int]:
    """The least time of the fused tail on the card: bytes (each input
    read once, each output written once) over HBM bandwidth, against
    3 flops a sample (fma + scale) over the fp32 peak."""
    nbytes = 4 * (S * C * N + S * C) + 4 * (S * N * C + S * C)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * S * C * N / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def phase_kernel(dev, shapes):
    rng = np.random.default_rng(7)
    # 128 MB read between launches evicts the 50 MB L2 with clean lines
    # (a write would leave dirty lines for the kernel to write back)
    flush = torch.zeros(32 << 20, dtype=torch.float32, device=dev)
    table = {}
    for S, C, N in shapes:
        x = torch.as_tensor((rng.standard_normal((S, C, N)) * 1000)
                            .astype(np.float32), device=dev)
        mem = torch.as_tensor((rng.standard_normal((S, C)) * 100)
                              .astype(np.float32), device=dev)
        pcm, m = deemph.deemphasis_pcm(x, mem)
        torch.cuda.synchronize()
        want_pcm, want_m = deemph.deemphasis_pcm_reference(x, mem)
        check(pcm.shape == (S, N, C) and pcm.is_contiguous(),
              f"kernel output {tuple(pcm.shape)} at {(S, C, N)}")
        check(bool(torch.isfinite(pcm).all()),
              f"kernel output not finite at {(S, C, N)}")
        scale = want_pcm.abs().max().item()
        err = (pcm - want_pcm).abs().max().item()
        # new_mem is unscaled: held to the same bar in its own units
        err_mem = (m - want_m).abs().max().item() / 32768.0
        check(max(err, err_mem) <= KERNEL_REL_TOL * scale,
              f"kernel vs plain at {(S, C, N)}: {err} / {err_mem} > "
              f"{KERNEL_REL_TOL} * {scale}")
        out = torch.empty_like(pcm)
        run = partial(deemph.deemphasis_pcm, x, mem)
        plain = partial(deemph.deemphasis_pcm_reference, x, mem)
        dev_ms = _device_ms(run, match="deemphasis_pcm_kernel")
        cold_ms = _device_ms(run, match="deemphasis_pcm_kernel",
                             between=flush.sum)
        plain_ms = _device_ms(plain)
        copy_ms = _device_ms(lambda: out.copy_(x.transpose(1, 2)))
        bms, bound_by, nbytes = bound_ms(S, C, N)
        row = dict(max_abs_err=err, bar=KERNEL_REL_TOL * scale,
                   kernel_device_ms=dev_ms,
                   kernel_device_ms_l2_flushed=cold_ms, bound_ms=bms,
                   bound_by=bound_by, bytes=nbytes, bound_share=bms / dev_ms,
                   bound_share_l2_flushed=bms / cold_ms,
                   plain_device_ms=plain_ms, copy_floor_ms=copy_ms,
                   call_ms=_cuda_ms(run, 200),
                   plain_call_ms=_cuda_ms(plain, 50))
        say(f"kernel_{S}x{C}x{N}", **row)
        table[(S, C, N)] = row
    return table


# ------------------------------------------------------ PVQ leaf kernels

def _reset_launches() -> None:
    """Every kernel's launch count to 0, just before a path's run."""
    deemph.reset_launches()
    pvq.reset_launches()
    band_asm.reset_launches()
    synthesis.reset_launches()
    plc.reset_launches()
    silk_nsq.reset_launches()
    silk_syn.reset_launches()
    fargan.reset_launches()
    rdovae.reset_launches()


def _neural_counts() -> dict:
    """The launch counts of the neural recovery's two kernels."""
    return {"fargan_conceal": fargan.conceal_frames_launches,
            "rdovae_decode": rdovae.decode_qframes_launches}


def _neural_launched(path: str, want: dict, rows: dict) -> dict:
    """The neural kernels' launches in a path's run (counted from 0 just
    before it) held to `want` ({kernel: launches}) and kept for the
    kernels line beside phase 3g's row `rows[kernel]`."""
    got = _neural_counts()
    check(got == {**dict.fromkeys(got, 0), **want},
          f"{path}: neural kernel launches {got}, {want} expected")
    for name, n in want.items():
        NEURAL_LAUNCHES[(path, name)] = (n, rows[name])
    return got


def _kernel_counts() -> dict:
    """The launch counts of the kernels besides the de-emphasis: those a
    decode step runs (the leaf stage's, the walk's, the band assembly's,
    the comb filter's and, on a lossy step, the concealment's rows), the
    SILK quantizers' and the device SILK synthesis'."""
    return {"pvq_leaf_stage": pvq.leaf_stage_launches,
            "cwrs_walk": pvq.cwrs_walk_launches,
            "band_assembly": band_asm.band_assembly_launches,
            "comb_filter": synthesis.comb_filter_launches,
            "plc_rows": plc.plc_rows_launches,
            "nsq_frame": silk_nsq.nsq_frame_launches,
            "nsq_del_dec": silk_nsq.nsq_del_dec_launches,
            "silk_synthesis": silk_syn.silk_synthesis_launches}


def _path_launches(path: str, steps: int, got=None, after_each=None,
                   calls_a_step: int = 1, lockstep: bool = False,
                   executor: bool = True) -> dict:
    """The step kernels' launches `got` (default: the counts now) in a
    path's run of `steps` steps (counts reset just before it), kept for
    the kernels line: the leaf stage and the band assembly exactly once
    and the comb filter exactly twice in each step and each of its
    `calls_a_step` executor calls (mesh shards); the walk launched, and
    at most once a tier a step, on a lockstep path (its plan emission
    walks), and never on another; counted after each step where
    `after_each` holds the counts, else over the run. A path without the
    plan executor (executor=False: the non-plan decoders) is held to the
    comb filter's alone. The concealment's launches are held by
    _guard_plc, step by step."""
    got = dict(_kernel_counts() if got is None else got)
    got.pop("plc_rows", None)
    for name in (*NSQ_KERNELS, "silk_synthesis"):
        check(got.pop(name, 0) == 0, f"{path}: {name} launched on a path "
              "that does not run it")
    if not executor:
        got = {"comb_filter": got["comb_filter"]}
    elif not lockstep:
        check(got.pop("cwrs_walk") == 0,
              f"{path}: the walk kernel launched outside a lockstep step")
    most = {"cwrs_walk": 3 * calls_a_step}
    exact = {"pvq_leaf_stage": calls_a_step, "band_assembly": calls_a_step,
             "comb_filter": 2 * calls_a_step}
    for name, n in got.items():
        if after_each is None:
            per = [n / steps]
        else:
            seen = [0] + [c[name] for c in after_each]
            per = [b - a for a, b in zip(seen, seen[1:])]
        if name in exact:
            check(all(x == exact[name] for x in per),
                  f"{path}: {name} launches a step {per}: {exact[name]} "
                  f"expected")
            continue
        check(n > 0, f"{path}: {name} never launched")
        check(max(per) <= most[name],
              f"{path}: {name} launches a step {per}: at most "
              f"{most[name]} expected")
    PATH_LAUNCHES[path] = got
    return got


def _golden_plans(dev, streams, S, frames):
    """{frame: the executor's planes} of the golden stereo streams at S
    streams (stream s plays golden stream s % 3), decoded by the native
    host stage under the current plan profile and unpacked on the
    card."""
    host = NativeCeltHostBatch(S)
    out = {}
    for f in range(max(frames) + 1):
        arenas, aux, _ = host.decode_plan_arenas(
            frame_batch(streams, S, f), FRAME)
        check(bool((aux["rcs"] >= 0).all()), f"host decode of frame {f}")
        if f not in frames:
            continue
        backing = torch.from_numpy(arenas["backing"].copy()).to(dev)
        p, *_ = band_exec.unpack_plan_arenas(
            *band_exec.split_backing(backing, channels=2, frame=FRAME,
                                     n_streams=S), channels=2, frame=FRAME)
        out[f] = band_exec._normalize_plan(p)
    return out


def _tier_leaves(p, t):
    """One tier's leaf planes of a plan, 1-D."""
    return {name: p[f"pvq_{name}"][t].reshape(-1) for name in LEAF_PLANES}


def _walk_check(label, leaves, nmax):
    """The walk kernel against the plain walk on one tier's leaves: iy
    equal. Returns iy."""
    walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
    iy = pvq.cwrs_walk(*walk_args, nmax)
    want_iy = pvq.cwrs_walk_reference(*walk_args, nmax)
    check(torch.equal(iy, want_iy), f"{label}: cwrs_walk differs from the "
          f"plain walk in {int((iy != want_iy).any(dim=1).sum())} leaves")
    return iy


def _written(p, cols: int):
    """(S, cols) bool: the points of X some active leaf writes, its
    values at pvq_dst .. pvq_dst + n - 1 inside [0, cols)."""
    dev = p["direct"].device
    mask = torch.zeros((p["direct"].shape[0], cols), dtype=torch.bool,
                       device=dev)
    for t, (nmax, _) in enumerate(TIERS):
        act, n, dst = (p[f"pvq_{x}"][t] for x in ("active", "n", "dst"))
        i = torch.arange(nmax, device=dev)
        pos = dst[..., None] + i
        on = (act[..., None] & (i < n[..., None]) & (pos >= 0)
              & (pos < cols))
        rows = torch.arange(mask.shape[0], device=dev)[:, None, None]
        mask[rows.expand_as(pos)[on], pos[on]] = True
    return mask


def _stage_planes(p, fn):
    """p with fn applied to each tier's plane of every leaf plane the stage
    reads."""
    return {**p, **{f"pvq_{name}": [fn(t) for t in p[f"pvq_{name}"]]
                    for name, _ in pvq.STAGE_PLANES}}


def _stage_check(label, p, channels):
    """The stage kernel against its plain version on one plan: each
    tier's pulse vectors (the kernel's pulse output) equal, X within
    LEAF_TOL and exactly 0.0 where no leaf writes, and X equal when the
    planes' streams lie further apart. Returns [streams, active leaves,
    the largest error]."""
    X, iys = pvq.leaf_stage(p, channels=channels, frame=FRAME, pulses=True)
    want, want_iys = pvq.leaf_stage_reference(p, channels=channels,
                                              frame=FRAME, pulses=True)
    for t, (iy, want_iy) in enumerate(zip(iys, want_iys)):
        check(torch.equal(iy, want_iy), f"{label} tier {t}: pulses differ "
              f"from the plain walk in "
              f"{int((iy != want_iy).any(dim=1).sum())} leaves")
    check(bool(torch.isfinite(X).all()), f"{label}: X not finite")
    err = (X - want).abs().max().item()
    check(err <= LEAF_TOL, f"{label}: leaf_stage {err} from the plain "
          f"version (bar {LEAF_TOL})")
    idle = ~_written(p, channels * FRAME)
    check(not bool(X[idle].any()) and not bool(want[idle].any()),
          f"{label}: X not 0.0 where no leaf writes")
    gapped = pvq.leaf_stage(_stage_planes(p, _gapped), channels=channels,
                            frame=FRAME)
    check(torch.equal(gapped, X), f"{label}: leaf_stage differs on planes "
          f"whose streams lie further apart")
    return [p["direct"].shape[0], sum(int(a.sum()) for a in p["pvq_active"]),
            err]


def _table_reads(tiers) -> tuple[int, int]:
    """(entries, reads) of the U table in the walks of these leaves, tiers
    a list of (iy (leaves, nmax), n): each entry some leaf reads counted
    once. At position j < n - 1, while k_j pulses are left, a leaf that
    places q_j there reads U(n - j, k_j + 1) and U(n - j, k_j - q_j ..
    k_j): q_j + 2 reads."""
    runs = np.zeros((U_N, U_K + 1), np.int64)
    reads = 0
    for iy, n in tiers:
        a = np.abs(iy).astype(np.int64)
        left = a.sum(axis=1, keepdims=True) - np.cumsum(a, axis=1) + a
        visit = ((np.arange(iy.shape[1])[None, :] < (n - 1)[:, None])
                 & (left > 0))
        leaf, j = np.nonzero(visit)
        row, q, kj = n[leaf] - j, a[leaf, j], left[leaf, j]
        # the entries read, as runs [kj - q, kj + 1] of a row: a
        # difference array a row
        np.add.at(runs, (row, kj - q), 1)
        np.add.at(runs, (row, kj + 2), -1)
        reads += int((q + 2).sum())
    return int((np.cumsum(runs, axis=1) > 0).sum()), reads


def walk_work(iy: np.ndarray, n: np.ndarray) -> tuple[int, int]:
    """(bytes, operations) the walk of these leaves needs, from its
    output iy (leaves, nmax): each plane read once (1 + 3 x 8 bytes a
    leaf), iy written once, and each U-table entry some leaf reads, once
    (_table_reads); three integer operations a read (load, compare,
    subtract)."""
    entries, reads = _table_reads([(iy, n)])
    return iy.shape[0] * 25 + 4 * entries + iy.nbytes, 3 * reads


def _rotation_flops(active, n, k, b, spread, nmax: int) -> int:
    """6 flops a rotation step (two products and a sum for each of the
    pair's two new values), each pass of a chain sweeping len - stride
    steps forward and len - 2 stride back."""
    rot = active & (2 * k < n) & (spread != 0) & (n <= nmax)
    flops = 0
    for nn, bb in zip(n[rot].tolist(), b[rot].tolist()):
        stride = max(bb, 1)
        st2 = 0
        if nn >= 8 * stride:
            st2 = 1
            while (st2 * st2 + st2) * stride + (stride >> 2) < nn:
                st2 += 1
        ln = nn // stride
        steps = max(ln - 1, 0) + max(ln - 2, 0)
        if st2:
            steps += max(ln - st2, 0) + max(ln - 2 * st2, 0)
        flops += 6 * steps * stride
    return flops


def leaf_stage_work(p, channels: int, iys) -> tuple[int, int]:
    """(bytes, operations) of the stage kernel on this plan. Bytes: every
    leaf plane read once (53 bytes a slot: a flag, six int64 planes, the
    float32 gain), each U-table entry some leaf's descent reads once
    (_table_reads over all tiers), X written once where the kernel writes
    it (8 bytes a point some active leaf places, _written; the zeroing of
    the rest is another kernel, not timed with this one); operations:
    three integer operations a table read, 3 flops a value of a walked
    leaf for the normalisation and the rotation's (_rotation_flops)."""
    tiers = [{k: v.cpu().numpy() for k, v in _tier_leaves(p, t).items()}
             for t in range(len(TIERS))]
    iys = [iy.cpu().numpy() for iy in iys]
    entries, reads = _table_reads([(iy, d["n"]) for iy, d in zip(iys, tiers)])
    nbytes = (53 * sum(d["n"].size for d in tiers) + 4 * entries
              + 8 * int(_written(p, channels * FRAME).sum()))
    ops = 3 * reads
    for d, (nmax, _) in zip(tiers, TIERS):
        walked = d["active"] & (d["n"] >= 1) & (d["n"] <= nmax)
        ops += 3 * int(d["n"][walked].sum()) + _rotation_flops(
            d["active"], d["n"], d["k"], d["b"], d["spread"], nmax)
    return nbytes, ops


def _kernel_times(name, fn, plain, nbytes: int, ops: int,
                  peak: float = FP32_FLOPS, plain_reps: int = 2) -> dict:
    """One kernel's device time a launch (torch.profiler), its bound
    (bytes over HBM bandwidth against operations over `peak`, the fp32
    peak by default), the plain version's device time and CUDA-event
    times of a call of both (the plain version's over `plain_reps`
    calls)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    ms = _device_ms(fn, match=KERNEL_SYMBOLS[name])
    return dict(ms=ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=ops,
                bound_share=max(t_bytes, t_ops) / ms,
                plain_ms=_device_ms(plain, reps=plain_reps,
                                    device_only=True),
                call_ms=_cuda_ms(fn, 100),
                plain_call_ms=_cuda_ms(plain, plain_reps))


def _walk_times(leaves, nmax):
    walk_args = [leaves[x] for x in ("active", "n", "k", "idx")]
    iy = pvq.cwrs_walk(*walk_args, nmax)
    # the plain walk is nmax + 12 steps of ~40 launches: one call
    return _kernel_times(
        "cwrs_walk", partial(pvq.cwrs_walk, *walk_args, nmax),
        partial(pvq.cwrs_walk_reference, *walk_args, nmax),
        *walk_work(iy.cpu().numpy(), leaves["n"].cpu().numpy()),
        plain_reps=1)


def _stage_times(p, channels):
    """The stage kernel's times on one plan (its one launch; the X
    plane's zeroing before it is another kernel), its bound, the plain
    version's times."""
    _, iys = pvq.leaf_stage(p, channels=channels, frame=FRAME, pulses=True)
    nbytes, ops = leaf_stage_work(p, channels, iys)
    # the plain version is some 11,000 launches: one call
    row = _kernel_times(
        "pvq_leaf_stage",
        partial(pvq.leaf_stage, p, channels=channels, frame=FRAME),
        partial(pvq.leaf_stage_reference, p, channels=channels,
                frame=FRAME), nbytes, ops, plain_reps=1)
    row.update(shape=[p["direct"].shape[0], channels,
                      [int(a.shape[1]) for a in p["pvq_active"]]],
               active=[int(a.sum()) for a in p["pvq_active"]])
    return row


def _step_sums(rows, name, max_abs_err):
    """A step's launches of one kernel, one row a launch: times and
    bounds summed, the bound of the launch with the largest."""
    sums = {key: sum(r[name][key] for r in rows)
            for key in ("ms", "bound_ms", "plain_ms", "call_ms",
                        "plain_call_ms")}
    longest = max(rows, key=lambda r: r[name]["bound_ms"])
    sums.update(bound_by=longest[name]["bound_by"],
                shape=[[r["leaves"], r["nmax"]] for r in rows],
                max_abs_err=max_abs_err)
    return sums


@contextlib.contextmanager
def _emission_walks():
    """Keep copies of the planes of the lockstep plan emission's walk
    launches (one a tier, celt_lockstep_emit.cwrs_walk) of the first step
    run inside: a list of (planes, nmax)."""
    calls = []
    walk = lockstep_emit.cwrs_walk

    def keep(active, n, k, idx, nmax):
        if len(calls) < len(TIERS):
            calls.append(({"active": active.clone(), "n": n.clone(),
                           "k": k.clone(), "idx": idx.clone()}, nmax))
        return walk(active, n, k, idx, nmax)

    lockstep_emit.cwrs_walk = keep
    try:
        yield calls
    finally:
        lockstep_emit.cwrs_walk = walk


def _emission_walk_times(path, calls):
    """The emission's walk planes of one step (_emission_walks) through
    the kernel against the plain walk (iy equal), then the times and
    bounds of each launch, kept for the path's kernels row."""
    check(len(calls) == len(TIERS),
          f"{path}: {len(calls)} emission walks seen in a step")
    rows = []
    for t, (leaves, nmax) in enumerate(calls):
        _walk_check(f"{path} emission tier {t}", leaves, nmax)
        rows.append({"leaves": leaves["n"].numel(), "nmax": nmax,
                     "active": int(leaves["active"].sum()),
                     "cwrs_walk": _walk_times(leaves, nmax)})
        say(f"emission_walk_{path}_tier{t}", **rows[-1])
    EMISSION_WALK[path] = _step_sums(rows, "cwrs_walk", 0.0)


def _plan_at(p, S, period):
    """The leaf planes of plan p (S_MAIN streams, stream s playing golden
    stream s % period) at S streams: stream s takes row s % period."""
    rows = torch.arange(S, device=p["direct"].device) % period
    return {"direct": p["direct"][rows],
            **{f"pvq_{name}": [t[rows] for t in p[f"pvq_{name}"]]
               for name, _ in pvq.STAGE_PLANES}}


def _device_plan(planes, dev):
    """leaf_cases.synthetic_plan's numpy planes as tensors on `dev`."""
    return {k: ([torch.as_tensor(t, device=dev) for t in v]
                if isinstance(v, list) else torch.as_tensor(v, device=dev))
            for k, v in planes.items()}


def phase_leaf_kernels(dev, streams, mono, widths):
    """The leaf stage kernel against its plain version on the card
    (_stage_check: iy exactly equal through the kernel's pulse output, X
    within LEAF_TOL and 0.0 where no leaf writes, the same X on planes
    whose streams lie further apart) on the golden stereo plans at S =
    256 under the serving profile (frames 0, 4 and 11), the mixed path's
    own mono plans (frames 0 and 4), a tight profile's plan, and a plan
    of the synthetic leaves of all three tiers (leaf_cases.
    synthetic_plan: every (n, k) with V(n, k) < 2^32, spans laid across
    the plane and cut at both of its edges); the walk kernel against the
    plain walk on every tier of those golden frames and on each tier's
    synthetic leaves. Then the times and bounds of the walk on each
    synthetic tier, of the stage on the synthetic plan and on its tier 2
    alone, and of the stage at every (S, C) in `widths` (golden frame 4,
    or the mixed path's frame 4 for C = 1). Returns {(S, C): the stage's
    row}."""
    golden = _golden_plans(dev, streams, S_MAIN, LEAF_FRAMES)
    plans = {f"celt_frame{f}": (golden[f], 2) for f in LEAF_FRAMES}
    mixed = OpusStreamPipeline(S_MAIN, channels=1, device=dev)
    for f in range(max(MIXED_FRAMES) + 1):
        with _kept_calls(band_exec, "leaf_stage", 1) as calls:
            mixed.step(frame_batch(mono, S_MAIN, f, packets=True))
        if f in MIXED_FRAMES:
            (p,), kw = calls[0]
            plans[f"mixed_frame{f}"] = (p, kw["channels"])
    del mixed
    set_plan_profile(*TIGHT_PROFILE)
    try:
        plans["tight_frame0"] = (_golden_plans(dev, streams, S_MAIN,
                                               (0,))[0], 2)
    finally:
        set_plan_profile(*SERVING_PROFILE)
    check(bool(plans["tight_frame0"][0]["direct"].any()),
          "the tight profile sent no stream to the direct decoder")
    synthetic = _device_plan(synthetic_plan(seed=100), dev)
    plans["synthetic"] = (synthetic, 2)
    # leaves past kmax(n): the kernel's descent over the full table
    plans["outside"] = (_device_plan(synthetic_plan(
        seed=200, source=outside_leaves), dev), 2)
    checked = {label: _stage_check(label, p, C)
               for label, (p, C) in plans.items()}
    worst = max(v[2] for v in checked.values())
    walked = 0
    for f in LEAF_FRAMES:
        for t, (nmax, _) in enumerate(TIERS):
            _walk_check(f"frame {f} tier {t}", _tier_leaves(golden[f], t),
                        nmax)
            walked += int(golden[f]["pvq_active"][t].sum())
    leaves = []
    for t, (nmax, _) in enumerate(TIERS):
        d = synthetic_leaves(nmax, seed=100 + t)
        leaves.append({k: torch.as_tensor(v, device=dev)
                       for k, v in d.items()})
        _walk_check(f"synthetic tier {t}", leaves[-1], nmax)
        walked += int(d["active"].sum())
        d = outside_leaves(nmax, seed=200 + t)
        _walk_check(f"outside tier {t}", {
            k: torch.as_tensor(v, device=dev) for k, v in d.items()}, nmax)
        walked += int(d["active"].sum())
    say("leaf_kernels", stage_cases=checked, stage_worst_err=worst,
        iy="equal", bar=LEAF_TOL, walk_checked_active_leaves=walked)
    # every tier with active leaves of every (n, k): what a tier the
    # golden frames leave idle would cost
    for t, (nmax, _) in enumerate(TIERS):
        say(f"walk_times_synthetic_tier{t}", leaves=leaves[t]["n"].numel(),
            nmax=nmax, active=int(leaves[t]["active"].sum()),
            **_walk_times(leaves[t], nmax))
    say("stage_times_synthetic", **_stage_times(synthetic, 2))
    tier2 = _stage_planes(synthetic, lambda t: t)
    for name, _ in pvq.STAGE_PLANES:
        planes = tier2[f"pvq_{name}"]
        tier2[f"pvq_{name}"] = [t[:, :0] for t in planes[:2]] + planes[2:]
    say("stage_times_synthetic_tier2", **_stage_times(tier2, 2))
    base = {2: (golden[LEAF_TIMING_FRAME], 3),
            1: (plans[f"mixed_frame{LEAF_TIMING_FRAME}"][0], len(mono))}
    table = {}
    for S, C in sorted(widths):
        p, period = base[C]
        row = _stage_times(p if S == S_MAIN else _plan_at(p, S, period), C)
        row.update(max_abs_err=worst)
        say(f"stage_times_S{S}_C{C}", **row)
        table[(S, C)] = row
    return table


# ------------------------------------ band assembly and comb filter (3c)

def _cloned(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: _cloned(t) for k, t in v.items()}
    if isinstance(v, list):
        return [_cloned(t) for t in v]
    return v


@contextlib.contextmanager
def _kept_calls(module, attr: str, limit: int):
    """Keep copies of the arguments of the first `limit` calls of
    module.attr made inside (tensors, and dicts and lists of them, cloned
    before the call runs): a list of (args, kwargs)."""
    calls = []
    fn = getattr(module, attr)

    def keep(*args, **kwargs):
        if len(calls) < limit:
            calls.append((tuple(_cloned(a) for a in args),
                          {k: _cloned(v) for k, v in kwargs.items()}))
        return fn(*args, **kwargs)

    setattr(module, attr, keep)
    try:
        yield calls
    finally:
        setattr(module, attr, fn)


@contextlib.contextmanager
def _step_calls():
    """The first leaf stage and band assembly calls and the first two comb
    filter calls (one decode step's) made inside."""
    with _kept_calls(band_exec, "leaf_stage", 1) as staged, \
            _kept_calls(band_exec, "band_assembly", 1) as assembled, \
            _kept_calls(synthesis, "comb_filter_batched", 2) as combed:
        yield staged, assembled, combed


def _record_frames() -> None:
    """From now on, keep the frame size of every band assembly call."""
    fn = band_exec.band_assembly

    def recorded(p, X, mats, **kw):
        FRAMES_DECODED.add(kw["frame"])
        return fn(p, X, mats, **kw)

    band_exec.band_assembly = recorded


def _guard_plc() -> None:
    """From now on, hold every plan step on the card to one launch of the
    concealment's row kernel where the host saw a lost stream and none
    where it saw none, filed under PLC_PATH[0] and the step's (S, C);
    and fail if the plain LPC synthesis runs on the card."""
    step = band_exec.plan_plc_core
    synth = plc._lpc_synthesis

    def guarded(consts, plc_consts, state, *args, any_lost, **kw):
        before = plc.plc_rows_launches
        out = step(consts, plc_consts, state, *args, any_lost=any_lost,
                   **kw)
        mem = state.decode_mem
        if mem.is_cuda:
            n = plc.plc_rows_launches - before
            check(n == int(any_lost), f"{PLC_PATH[0]}: plc_rows launched "
                  f"{n} times in a step with any_lost={any_lost}")
            key = (PLC_PATH[0], mem.shape[0], mem.shape[1])
            seen = PLC_LAUNCHES.setdefault(key, [0, 0, 0])
            seen[0] += 1
            seen[1] += int(any_lost)
            seen[2] += n
        return out

    def plain_synthesis(e_ext, tail, lpc):
        check(not e_ext.is_cuda, f"{PLC_PATH[0]}: the plain LPC synthesis "
              "ran on the card")
        return synth(e_ext, tail, lpc)

    band_exec.plan_plc_core = guarded
    plc._lpc_synthesis = plain_synthesis


@contextlib.contextmanager
def _plc_label(name: str):
    """File the concealment guard's counts under `name` inside."""
    PLC_PATH[0] = name
    try:
        yield
    finally:
        PLC_PATH[0] = "other"


def _plc_held(label: str, widths) -> dict:
    """The guard's counts under `label` at each (S, C) of `widths`: a
    lossy step there, and one launch a lossy step (a mesh shard's each).
    Returns {"S{S}_C{C}": launches}."""
    out = {}
    for S, C in widths:
        steps, lossy, n = PLC_LAUNCHES.get((label, S, C), (0, 0, 0))
        check(lossy > 0 and n == lossy, f"{label} at ({S}, {C}): {n} "
              f"plc_rows launches in {lossy} lossy of {steps} steps")
        out[f"S{S}_C{C}"] = n
    return out


_STACKS: dict = {}


def _stacks(frame: int, dev):
    """The plain version's operators on the card: the (21, NC, NBMAX,
    NBMAX) float64 stacks."""
    if frame not in _STACKS:
        _STACKS[frame] = tuple(operator64(a, dev)
                               for a in plan_combo_mats_np(frame))
    return _STACKS[frame]


def _gapped(t):
    """t's values in a view whose streams lie one element further apart
    than its rows' length, as the plan arena's planes and a column of the
    host's flag plane do."""
    wide = torch.zeros((t.shape[0], t[0].numel() + 1), dtype=t.dtype,
                       device=t.device)
    wide[:, :-1] = t.reshape(t.shape[0], -1)
    return wide[:, :-1].view(t.shape)


def _assembly_check(label, call):
    """The band assembly kernel against its plain version on one call's
    arguments (the executor's planes and X plane): X within
    ASSEMBLY_TOL, and equal when the planes' streams lie further apart.
    Returns [streams, channels, frame, the largest error, the values
    whose float32 rounding differs, the bands in the kernel's parallel
    pass, in its ordered pass, the most ordered bands of a stream]."""
    (p, X, mats), kw = call
    got = band_asm.band_assembly(p, X.clone(), mats, **kw)
    want = band_asm.band_assembly_reference(
        p, X.clone(), _stacks(kw["frame"], X.device), **kw)
    check(bool(torch.isfinite(got).all()), f"{label}: X not finite")
    err = (got - want).abs().max().item()
    check(err <= ASSEMBLY_TOL, f"{label}: band_assembly {err} from the plain "
          f"version (bar {ASSEMBLY_TOL})")
    gapped = band_asm.band_assembly(
        {k: _gapped(p[k]) for k in band_asm.PLANE_KEYS}, X.clone(), mats,
        **kw)
    check(torch.equal(gapped, got), f"{label}: band_assembly differs on "
          f"planes whose streams lie further apart")
    flips = int((got.float() != want.float()).sum())
    passes = band_asm.band_passes(
        p, **{k: kw[k] for k in ("channels", "lm", "start", "end")})
    return [X.shape[0], kw["channels"], kw["frame"], err, flips,
            int((passes == 1).sum()), int((passes == 2).sum()),
            int((passes == 2).sum(axis=1).max())]


def _comb_check(label, call):
    """The comb filter kernel against its plain version on one call's
    arguments: each row within COMB_ULPS float32 ulps of its peak
    magnitude, equal when the planes' streams lie further apart, the rows
    it skips (g0 = g1 = 0) and, where g1 = 0, the
    samples after the blend bit for bit. Returns [the largest error, in
    ulps of the row's peak]."""
    (consts, buf, pos, N, t0, t1, g0, g1, tap0, tap1), _ = call
    planes = (t0, t1, g0, g1, tap0, tap1)
    got = synthesis.comb_filter_batched(consts, buf.clone(), pos, N, *planes)
    want = synthesis.comb_filter_batched_reference(consts, buf.clone(), pos,
                                                   N, *planes)
    gapped = synthesis.comb_filter_batched(consts, buf.clone(), pos, N,
                                           *map(_gapped, planes))
    check(torch.equal(gapped, got), f"{label}: comb_filter differs on "
          f"planes whose streams lie further apart")
    diff = (got - want).abs()
    peak = want.abs().amax(dim=2, keepdim=True)
    ulp = 2.0 ** -23 * peak
    check(bool((diff <= COMB_ULPS * ulp).all()),
          f"{label}: comb_filter beyond {COMB_ULPS} ulps of a row's peak")
    skip = (g0 == 0) & (g1 == 0)
    check(torch.equal(got[skip], buf[skip]),
          f"{label}: comb_filter changed a row it skips")
    same = (g0 == g1) & (t0 == t1) & (tap0 == tap1)
    stop = pos + min(synthesis.OVERLAP, N)
    tail = (g1 == 0) & ~same
    check(torch.equal(got[tail][..., stop:], buf[tail][..., stop:]),
          f"{label}: comb_filter ran past the blend where g1 = 0")
    ulps = (diff / ulp.clamp(min=1e-30)).max().item()
    return [diff.max().item(), ulps]


def assembly_work(p, kw, dense: bool = False) -> tuple[int, int]:
    """(bytes, operations) of the band assembly on these planes: the X
    plane's bins of bands start..end-1 read and written once (float64),
    each plane read once, each operator block some call reads once, by
    its nonzeros (a float32 value and a one-byte column each); 2
    float64 operations a nonzero of the block for the post product of
    every call of a band with n_b > 1 and for the pre product where a
    live fold fill reads it (the elementwise work is not counted).
    dense: the dense count instead, whole n_b x n_b float32 blocks read
    and 2 n_b^2 operations a product."""
    C, lm, frame = kw["channels"], kw["lm"], kw["frame"]
    q = {k: p[k].cpu().numpy() for k in band_asm.PLANE_KEYS}
    S = q["call_active"].shape[0]
    widths = band_asm._band_widths(lm)
    bins = sum(widths[kw["start"]:kw["end"]])
    nbytes = 2 * S * C * bins * 8 + sum(v.nbytes for v in q.values())
    fold = ((q["fill_active"] & q["fill_fold"]).any(axis=3)
            & q["call_active"])
    stacks = dict(zip(("pre", "post"), plan_combo_mats_np(frame)))
    flops, blocks = 0, set()
    for i in range(kw["start"], kw["end"]):
        n_b = widths[i]
        if n_b == 1:
            continue
        calls = {"post": q["call_post"][:, i, :C].ravel(),
                 "pre": q["call_pre"][:, i, :C][fold[:, i, :C]]}
        for op, combos in calls.items():
            nnz = (stacks[op][i, :, :n_b, :n_b] != 0).sum(axis=(1, 2))
            per = np.full_like(nnz, n_b * n_b) if dense else nnz
            flops += 2 * int(per[combos].sum())
            blocks |= {(op, i, int(c), 4 * n_b * n_b if dense
                        else 5 * int(nnz[c])) for c in np.unique(combos)}
    nbytes += sum(b[3] for b in blocks)
    return nbytes, flops


def comb_work(call) -> tuple[int, int]:
    """(bytes, operations) of the comb filter on one call: for each row
    of an active stream, the decode memory its taps reach ([pos - max(t0,
    t1) - 2, pos + the samples it changes)) read once and the samples it
    changes written once (a row with g1 = 0 stops after the blend),
    the six parameters, the window and the tap gains read once; 32
    float32 operations a changed sample (the window's square, 1 - f, ten
    weights, ten products, ten sums)."""
    (consts, buf, pos, N, *planes), _ = call
    t0, t1, g0, g1, tap0, tap1 = (v.cpu().numpy() for v in planes)
    S, C, _ = buf.shape
    active = (g0 != 0) | (g1 != 0)
    same = (g0 == g1) & (t0 == t1) & (tap0 == tap1)
    blend = np.minimum(np.where(same, 0, synthesis.OVERLAP), N)
    changed = np.where(g1 != 0, N, blend) * active
    reach = np.maximum(t0, t1).astype(np.int64) + 2
    span = (pos + changed - np.maximum(pos - reach, 0)) * active
    nbytes = (4 * C * int(span.sum() + changed.sum()) + 24 * S
              + 4 * (synthesis.OVERLAP + 9))
    return nbytes, 32 * C * int(changed.sum())


def _assembly_times(call):
    """The band assembly's times on one call's arguments: the kernel, the
    plain version, the bound (float64 operations at FP64_FLOPS), and the
    bound under the dense count beside it."""
    (p, X, mats), kw = call
    Xw = torch.empty_like(X)
    row = _kernel_times(
        "band_assembly",
        lambda: band_asm.band_assembly(p, Xw.copy_(X), mats, **kw),
        lambda: band_asm.band_assembly_reference(
            p, Xw.copy_(X), _stacks(kw["frame"], X.device), **kw),
        *assembly_work(p, kw), peak=FP64_FLOPS)
    dense_bytes, dense_ops = assembly_work(p, kw, dense=True)
    row.update(shape=[X.shape[0], kw["channels"], kw["frame"]],
               dense_count_bytes=dense_bytes, dense_count_operations=dense_ops,
               dense_count_bound_ms=max(dense_bytes / HBM_BYTES_PER_S,
                                        dense_ops / FP64_FLOPS) * 1e3)
    return row


def _comb_times(calls):
    """The comb filter's times over one step's calls, summed: each call's
    kernel and plain version on copies of its decode memory."""
    rows = []
    for call in calls:
        (consts, buf, pos, N, *planes), _ = call
        bw = torch.empty_like(buf)
        rows.append(_kernel_times(
            "comb_filter",
            lambda: synthesis.comb_filter_batched(consts, bw.copy_(buf), pos,
                                                  N, *planes),
            lambda: synthesis.comb_filter_batched_reference(
                consts, bw.copy_(buf), pos, N, *planes),
            *comb_work(call)))
        rows[-1]["shape"] = [*buf.shape[:2], N]
    out = {key: sum(r[key] for r in rows)
           for key in ("ms", "bound_ms", "plain_ms", "call_ms",
                       "plain_call_ms", "bytes", "operations")}
    out["bound_by"] = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
    out["bound_share"] = out["bound_ms"] / out["ms"]
    out["shape"] = [r["shape"] for r in rows]
    return out


def _own_step_rows(path, staged, assembled, combed):
    """A lockstep path's first step: its own leaf stage, band assembly and
    comb filter calls through the kernels against the plain versions,
    and their times, kept for the path's kernels rows."""
    check(len(staged) == 1 and len(assembled) == 1 and len(combed) == 2,
          f"{path}: {len(staged)} leaf stage, {len(assembled)} band "
          f"assembly and {len(combed)} comb filter calls seen in a step")
    (p,), kw = staged[0]
    stage_err = _stage_check(f"{path} leaf stage", p, kw["channels"])
    err = _assembly_check(f"{path} band assembly", assembled[0])
    ulps = [_comb_check(f"{path} comb call {k}", c)
            for k, c in enumerate(combed)]
    rows = {"pvq_leaf_stage": dict(_stage_times(p, kw["channels"]),
                                   max_abs_err=stage_err[2]),
            "band_assembly": dict(_assembly_times(assembled[0]),
                                  max_abs_err=err[3], f32_flips=err[4]),
            "comb_filter": dict(_comb_times(combed),
                                max_abs_err=max(u[0] for u in ulps),
                                max_ulps_of_peak=max(u[1] for u in ulps))}
    OWN_STEP_ROWS[path] = rows
    say(f"step_kernels_{path}", **rows)


def _executor_call(dev, arenas, aux, channels: int, frame: int):
    """One execute_packed on the card over a host batch's arenas (under
    the plan profile they were made with); returns its band assembly
    call's arguments and the streams that fell back to the direct
    decoder."""
    S = aux["x_direct"].shape[0]
    backing = torch.from_numpy(arenas["backing"].copy()).to(dev)
    p, *_ = band_exec.unpack_plan_arenas(
        *band_exec.split_backing(backing, channels=channels, frame=frame,
                                 n_streams=S), channels=channels, frame=frame)
    lm = {120: 0, 240: 1, 480: 2, 960: 3}[frame]
    with _kept_calls(band_exec, "band_assembly", 1) as calls:
        band_exec.execute_packed(
            p, torch.from_numpy(aux["x_direct"].copy()).to(dev),
            plan_combo_mats(channels, frame, dev), channels=channels,
            frame=frame, lm=lm, start=0, end=21)
    return calls[0], int(p["direct"].sum())


def _encoded_arenas(dev, streams, S, C, frame, frames=3):
    """Plan arenas of frame size `frame` (LM 0-2): the golden stereo PCM
    (stream s plays fixture s % 3; mono: the channels' mean) encoded on
    the card by CeltEncodePipeline, decoded by the native host stage.
    Returns the last frame's (arenas, aux)."""
    bitrate = ENCODE_BITRATE if C == 2 else ENCODE_BITRATE // 2
    enc = CeltEncodePipeline(S, C, bitrate, frame_size=frame, device=dev)
    host = NativeCeltHostBatch(S, channels=C, disable_inv=C == 1)
    for f in range(frames):
        pcm = np.stack([streams[s % len(streams)].pcm[f * frame:
                                                      (f + 1) * frame]
                        for s in range(S)]).astype(np.float32)
        if C == 1:
            pcm = pcm.mean(axis=2, keepdims=True)
        arenas, aux, _ = host.decode_plan_arenas(enc.step(pcm), frame)
        check(bool((aux["rcs"] >= 0).all()),
              f"host decode of encoded frame {f} at {frame}")
    return arenas, aux


def _rows_at(call, S, period, assembly: bool):
    """One call's arguments at S streams: stream s takes row s % period
    (the golden fixture it plays)."""
    args, kw = call
    rows = torch.arange(S) % period

    def tile(v):
        if isinstance(v, dict):
            return {k: tile(t) for k, t in v.items()}
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            return v[rows.to(v.device)].contiguous()
        return v

    if assembly:
        p, X, mats = args
        return (tile(p), tile(X), mats), kw
    consts, *rest = args
    return (consts, *(tile(v) for v in rest)), kw


def _forced_order(call):
    """The call with each live fold call's source window moved onto the
    norm region of the first later band of the kernel's parallel pass
    that writes there: those bands then run in the ordered pass. Returns
    (the call, the bands so forced)."""
    (p, X, mats), kw = call
    span = {k: kw[k] for k in ("channels", "lm", "start", "end")}
    C = kw["channels"]
    before = band_asm.band_passes(p, **span)
    q = {k: p[k].cpu().numpy() for k in band_asm.PLANE_KEYS}
    live = ((q["fill_active"] & q["fill_fold"]).any(axis=3)
            & q["call_active"])[:, :, :C]
    writes = (q["call_norm_write"] & q["call_active"])[:, :, :C].any(axis=2)
    t = band_asm._band_table(kw["lm"], kw["start"])
    lb = q["call_lb_src"].copy()
    for s, j, slot in np.argwhere(live & (before == 2)[:, :, None]):
        later = [k for k in range(j + 1, kw["end"]) if before[s, k] == 1
                 and writes[s, k] and t.nwoff[k] >= 0]
        if later:
            lb[s, j, slot] = t.nwoff[later[0]]
    moved = dict(p, call_lb_src=torch.as_tensor(lb, device=X.device))
    after = band_asm.band_passes(moved, **span)
    return ((moved, X, mats), kw), int(((after == 2) & (before == 1)).sum())


# the comb kernel's chunk classes by min(t0, t1): the plain version's 13
# (min 15 or less), one warp (16-34), up to four warps (35-129), the 128
# lanes of a row (130 or more)
CHUNK_CLASSES = (("chunk13", 0, 16), ("one_warp", 16, 35),
                 ("four_warps", 35, 130), ("chunk128", 130, 1 << 30))


def _min_lags(calls) -> dict:
    """The distribution of min(t0, t1) over the active rows (g0 or g1
    not 0) of comb filter calls (args as _kept_calls keeps them): rows
    by chunk class, the calls that hold a row of chunk 13 (it bounds the
    call), and the rows the filter skips."""
    hist = {name: 0 for name, _, _ in CHUNK_CLASSES}
    bound13 = skipped = 0
    for (_, buf, _, _, t0, t1, g0, g1, _, _), _ in calls:
        act = ((g0 != 0) | (g1 != 0)).cpu().numpy()
        low = torch.minimum(t0, t1).cpu().numpy()[act]
        C = buf.shape[1]
        for name, a, b in CHUNK_CLASSES:
            hist[name] += C * int(((low >= a) & (low < b)).sum())
        bound13 += int((low < 16).any())
        skipped += C * int((~act).sum())
    return dict(rows=hist, calls=len(calls), calls_with_chunk13=bound13,
                rows_skipped=skipped)


def _bench_rows(dev, steps=4):
    """The comb filter calls of the bench's decode (its synthetic
    packets, stream s playing frame (i + s) % 48 at step i) at S = 256,
    steps 1..steps-1 (step 0 starts from no postfilter)."""
    pays = bench.load_fixture()["synthetic"]["payloads"]
    pipe = CeltStreamPipeline(S_MAIN, channels=2, use_plan=True, device=dev)
    calls = []
    for i in range(steps):
        with _kept_calls(synthesis, "comb_filter_batched", 2) as c:
            pipe.step([pays[(i + s) % len(pays)] for s in range(S_MAIN)],
                      FRAME)
        calls += c if i else []
    return calls


def phase_step_kernels(dev, streams, mono, widths):
    """The band assembly and comb filter kernels against their plain
    versions on the card: (a) the band assembly on the plan decoders' own
    calls (golden stereo at S = 256 under the serving profile, frames 0,
    4 and 11; the mixed path's mono arenas, frames 0 and 4), the tight
    profile's direct fallback, and plans of 2.5, 5 and 10 ms frames
    encoded on the card, stereo and mono; (b) the comb filter on those
    steps' decode memory and on seeded rows (comb_cases.comb_rows) at
    every frame size; (c) the times and bounds of a step's launches of
    each at every width in `widths` ({kernel: {(S, C)}}). Returns {kernel:
    {(S, C): row}}."""
    assembled, combed = {}, {}
    golden_lags = []
    pipe = CeltStreamPipeline(S_MAIN, channels=2, use_plan=True, device=dev)
    for f in range(max(ASSEMBLY_FRAMES) + 1):
        with _step_calls() as (_, a, c):
            pipe.step(frame_batch(streams, S_MAIN, f), FRAME)
        golden_lags += c if f else []
        if f in ASSEMBLY_FRAMES:
            assembled[f"celt_frame{f}"] = a[0]
            combed.update({f"celt_frame{f}_call{k}": x
                           for k, x in enumerate(c)})
    del pipe
    mixed = OpusStreamPipeline(S_MAIN, channels=1, device=dev)
    for f in range(max(MIXED_FRAMES) + 1):
        with _step_calls() as (_, a, c):
            mixed.step(frame_batch(mono, S_MAIN, f, packets=True))
        if f in MIXED_FRAMES:
            assembled[f"mixed_frame{f}"] = a[0]
            combed.update({f"mixed_frame{f}_call{k}": x
                           for k, x in enumerate(c)})
    del mixed
    set_plan_profile(*TIGHT_PROFILE)
    try:
        host = NativeCeltHostBatch(S_MAIN)
        arenas, aux, _ = host.decode_plan_arenas(
            frame_batch(streams, S_MAIN, 0), FRAME)
        check(bool((aux["rcs"] >= 0).all()), "host decode, tight profile")
        assembled["tight_frame0"], direct = _executor_call(dev, arenas, aux,
                                                           2, FRAME)
    finally:
        set_plan_profile(*SERVING_PROFILE)
    check(direct > 0, "the tight profile sent no stream to the direct "
          "decoder")
    assembled["forced_order_frame4"], forced = _forced_order(
        assembled["celt_frame4"])
    check(forced > 0, "moving the fold sources forced no band into the "
          "ordered pass")
    say("comb_min_lag", golden=_min_lags(golden_lags),
        bench=_min_lags(_bench_rows(dev)))
    del golden_lags
    for C in (2, 1):
        for n in SHORT_FRAMES:
            arenas, aux = _encoded_arenas(dev, streams, S_MAIN, C, n)
            assembled[f"encoded_c{C}_n{n}"], _ = _executor_call(
                dev, arenas, aux, C, n)
    rng = np.random.default_rng(14)
    for C in (2, 1):
        for n in (*SHORT_FRAMES, FRAME):
            consts = synthesis.make_consts(n, dev)
            for k, (pos, N) in enumerate(comb_calls(n)):
                d = {key: torch.as_tensor(v, device=dev)
                     for key, v in comb_rows(rng, S_MAIN, C).items()}
                combed[f"seeded_c{C}_n{n}_call{k}"] = ((
                    consts, d["buf"], pos, N, d["t0"], d["t1"], d["g0"],
                    d["g1"], d["tap0"], d["tap1"]), {})
    checked = {label: _assembly_check(label, call)
               for label, call in assembled.items()}
    comb_errs = {label: _comb_check(label, call)
                 for label, call in combed.items()}
    worst = max(v[3] for v in checked.values())
    comb_worst = max(v[0] for v in comb_errs.values())
    comb_ulps = max(v[1] for v in comb_errs.values())
    say("step_kernels", assembly_cases=checked, assembly_worst_err=worst,
        assembly_bar=ASSEMBLY_TOL, tight_profile_direct_streams=direct,
        forced_order_bands=forced,
        comb_cases=comb_errs, comb_worst_abs_err=comb_worst,
        comb_worst_ulps_of_peak=comb_ulps, comb_bar_ulps=COMB_ULPS)
    base = {2: ("celt_frame4", 3), 1: ("mixed_frame4", len(mono))}
    table = {"band_assembly": {}, "comb_filter": {}}
    for S, C in sorted(widths["band_assembly"]):
        label, period = base[C]
        call = assembled[label]
        row = _assembly_times(call if S == S_MAIN
                              else _rows_at(call, S, period, True))
        row.update(max_abs_err=worst)
        say(f"assembly_times_S{S}_C{C}", **row)
        table["band_assembly"][(S, C)] = row
    for S, C in sorted(widths["comb_filter"]):
        label, period = base[C]
        calls = [combed[f"{label}_call{k}"] for k in range(2)]
        row = _comb_times(calls if S == S_MAIN else
                          [_rows_at(c, S, period, False) for c in calls])
        row.update(max_abs_err=comb_worst, max_ulps_of_peak=comb_ulps)
        say(f"comb_times_S{S}_C{C}", **row)
        table["comb_filter"][(S, C)] = row
    return table


# ------------------------------------------- the concealment's rows (3d)

def _lossy_calls(make_pipe, batch_fn, frames: int):
    """The plc_rows and celt_plc_freq calls of a pipeline's steps under
    phase 5's loss pattern (seed 17, ~10% from frame 1, stream 1 lost in
    frames 5 and 6: second losses with the 0.8 fade and carried LPC)."""
    rng = np.random.default_rng(17)
    lost = rng.random((S_MAIN, frames)) < 0.10
    lost[:, 0] = False
    lost[1, 5:7] = True
    pipe = make_pipe()
    with _kept_calls(plc, "plc_rows", frames) as rows, \
            _kept_calls(plc, "celt_plc_freq", frames) as freqs:
        for f in range(frames):
            pipe.step(batch_fn(S_MAIN, f, lost[:, f]))
    check(0 < len(rows) <= int(lost.any(axis=0).sum()),
          f"{len(rows)} concealment calls in {frames} frames")
    return rows, freqs


def _rows_args(call):
    (consts, hist, first, lost, pitch, fade, lpc_prev), kw = call
    return consts, (hist, first, lost, pitch, fade, lpc_prev), kw["n_ext"]


def _plc_check(label, call, well_conditioned: bool):
    """The kernel against its plain version on one plc_rows call: lost
    rows' LPC within PLC_LPC_TOL of the plain version (well-conditioned
    rows) or no further from the float64 fit than the plain version plus
    PLC_LPC_TOL (real histories), their ext within PLC_EXT_TOL of each
    row's peak; the other rows ext 0.0 and the carried LPC. Returns [rows
    lost, the largest ext error, in units of the row's peak, the largest
    LPC error, the rows whose LPC bits differ, the rows whose ext bits
    differ]."""
    consts, args, n_ext = _rows_args(call)
    hist, first, lost, _, _, lpc_prev = args
    lpc, ext = plc.plc_rows(consts, *args, n_ext=n_ext)
    want_lpc, want_ext = plc.plc_rows_reference(consts, *args, n_ext=n_ext)
    check(bool(torch.isfinite(ext).all() and torch.isfinite(lpc).all()),
          f"{label}: plc_rows output not finite")
    check(bool((ext[~lost] == 0).all()), f"{label}: ext of a row that is "
          "not lost is not 0.0")
    check(torch.equal(lpc[~lost | ~first], lpc_prev[~lost | ~first]),
          f"{label}: a carried LPC changed")
    peak = want_ext.abs().amax(dim=-1, keepdim=True)
    diff = (ext - want_ext).abs()[lost]
    check(bool((diff <= PLC_EXT_TOL * peak[lost]).all()),
          f"{label}: ext beyond {PLC_EXT_TOL} of a row's peak")
    lpc_err = (lpc - want_lpc).abs()[lost].max().item()
    fit = first & lost
    if well_conditioned:
        check(lpc_err <= PLC_LPC_TOL, f"{label}: LPC {lpc_err} from the "
              f"plain version (bar {PLC_LPC_TOL})")
    elif fit.any():
        exact = torch.as_tensor(plc_cases.lpc_fit_f64(
            consts["han"].cpu().numpy(), consts["lagw"].cpu().numpy(),
            hist[fit].cpu().numpy()), device=hist.device)
        got = (lpc[fit].double() - exact).abs().max().item()
        plain = (want_lpc[fit].double() - exact).abs().max().item()
        check(got <= plain + PLC_LPC_TOL, f"{label}: LPC {got} from the "
              f"float64 fit, the plain version {plain}")
    rel = (diff / peak[lost].clamp(min=1e-30)).max().item() if lost.any() \
        else 0.0
    flips = int((lpc != want_lpc).any(dim=-1)[lost].sum())
    ext_flips = int((ext != want_ext).any(dim=-1)[lost].sum())
    return [int(lost.sum()) * hist.shape[1], diff.max().item()
            if diff.numel() else 0.0, rel, lpc_err, flips, ext_flips]


def _freq_check(label, call):
    """celt_plc_freq through the kernel against its plain route: the
    lost streams' re-entry spectrum within PLC_EXT_TOL of its largest
    value. Returns the relative error."""
    args, kw = call
    lost = args[3]
    got, _ = plc.celt_plc_freq(*args, **kw)
    rows = plc.plc_rows
    plc.plc_rows = plc.plc_rows_reference
    try:
        want, _ = plc.celt_plc_freq(*args, **kw)
    finally:
        plc.plc_rows = rows
    scale = want[lost].abs().max().item()
    err = (got - want)[lost].abs().max().item()
    check(err <= PLC_EXT_TOL * scale, f"{label}: freq {err} from the plain "
          f"route (bar {PLC_EXT_TOL} * {scale})")
    return err / scale


def plc_work(first, lost, pitch, C: int, n_ext: int) -> tuple[int, int]:
    """(bytes, operations) one plc_rows call needs on these inputs: the
    planes, the history of each lost row, the carried LPC of each row
    that keeps it, the window and lag tables where a row is fitted, each
    output once; operations for each lost row (the autocorrelation's 25
    lags and the Levinson recursion where it is fitted, the residual, the
    energies of up to two pitch periods, the excitation and the
    synthesis)."""
    S = lost.shape[0]
    n_lost = int(lost.sum()) * C
    n_fit = int((lost & first).sum()) * C
    nbytes = (10 * S + 4 * plc.HIST * n_lost
              + 4 * plc.ORDER * (S * C - n_fit)
              + (4 * (plc.HIST + 2 * plc.ORDER) if n_fit else 0)
              + 4 * S * C * (plc.ORDER + n_ext))
    fit = (2 * sum(plc.HIST - lag for lag in range(plc.ORDER + 1))
           + plc.HIST + sum(2 * i + 8 for i in range(plc.ORDER)) + plc.ORDER)
    p = pitch[lost].long()
    energies = int((4 * torch.clamp(2 * p, max=plc.HIST)).sum()) * C
    row = 2 * plc.ORDER * plc.HIST + 4 * n_ext + (2 * plc.ORDER + 2) * n_ext
    return nbytes, n_fit * fit + n_lost * row + energies


def _plc_times(label, call):
    """The kernel's device time on one call (torch.profiler), its bound,
    the plain version's device time, the worst ext error."""
    consts, args, n_ext = _rows_args(call)
    hist, first, lost, pitch, _, _ = args
    run = partial(plc.plc_rows, consts, *args, n_ext=n_ext)
    plain = partial(plc.plc_rows_reference, consts, *args, n_ext=n_ext)
    nbytes, ops = plc_work(first, lost, pitch, hist.shape[1], n_ext)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_FLOPS * 1e3
    ms = _device_ms(run, match="plc_rows_kernel")
    _, ext = run()
    _, want = plain()
    row = dict(shape=list(hist.shape[:2]) + [n_ext],
               streams_lost=int(lost.sum()), ms=ms,
               ns_a_synthesis_step=ms * 1e6 / n_ext,
               plain_ms=_device_ms(plain, reps=2, device_only=True),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, operations=ops,
               max_abs_err=(ext - want)[lost].abs().max().item()
               if lost.any() else 0.0)
    row["bound_share"] = row["bound_ms"] / ms
    say(f"plc_times_{label}", **row)
    return row


def _rows_of(call, S: int, lost_all: bool = False):
    """A plc_rows call's arguments for S streams (the call's streams
    repeated or cut), every stream lost at a first loss with lost_all."""
    consts, args, n_ext = _rows_args(call)
    reps = -(-S // args[0].shape[0])
    args = [torch.cat([a] * reps)[:S].contiguous() for a in args]
    if lost_all:
        args[1] = torch.ones_like(args[1])
        args[2] = torch.ones_like(args[2])
        args[4] = torch.ones_like(args[4])
    return (consts, *args), {"n_ext": n_ext}


def phase_plc_kernel(dev, streams, mono, widths):
    """The concealment's row kernel (ops/plc.plc_rows) against its plain
    version on the card: the calls of phase 5's and phase 9's lossy steps
    at S = 256 (stereo and mono) and the seeded rows of plc_cases.py;
    celt_plc_freq through both routes on the stereo steps; then the
    kernel's time at each (S, C) of `widths` with ~10% of the streams
    lost, at (256, 2) with every stream lost, and of one row alone (the
    chain). Returns {(S, C): row, "all_lost": row, "chain": row}."""
    frames = 8
    celt_rows, celt_freqs = _lossy_calls(
        lambda: CeltStreamPipeline(S_MAIN, use_plan=True, device=dev),
        partial(frame_batch, streams), frames)
    mono_rows, _ = _lossy_calls(
        lambda: OpusStreamPipeline(S_MAIN, channels=1, device=dev),
        partial(frame_batch, mono, packets=True), frames)
    seeded = plc_cases.plc_rows(np.random.default_rng(18))
    consts = _rows_args(celt_rows[0])[0]
    seeded_call = ((consts, *(torch.as_tensor(seeded[k], device=dev)
                              for k in ("hist", "first", "lost", "pitch",
                                        "fade", "lpc_prev"))),
                   {"n_ext": FRAME + plc.OVERLAP})
    cases = {f"celt_step{k}": (c, False) for k, c in enumerate(celt_rows)}
    cases.update({f"mixed_step{k}": (c, False)
                  for k, c in enumerate(mono_rows)})
    cases["seeded"] = (seeded_call, True)
    cases["seeded_lm1"] = ((seeded_call[0], {"n_ext": 240 + plc.OVERLAP}),
                           True)
    checked = {label: _plc_check(label, call, wc)
               for label, (call, wc) in cases.items()}
    check(any(bool((~c[0][2] & c[0][3]).any()) for c in celt_rows),
          "no second loss among the stereo steps")
    freq_err = max(_freq_check(f"celt_step{k}", c)
                   for k, c in enumerate(celt_freqs))
    say("plc_kernel", cases=checked,
        worst_ext_err=max(v[1] for v in checked.values()),
        worst_ext_err_of_peak=max(v[2] for v in checked.values()),
        worst_lpc_err=max(v[3] for v in checked.values()),
        lpc_rows_with_other_bits=sum(v[4] for v in checked.values()),
        ext_rows_with_other_bits=sum(v[5] for v in checked.values()),
        worst_freq_err_of_max=freq_err, ext_bar=PLC_EXT_TOL,
        lpc_bar=PLC_LPC_TOL)
    base = {2: celt_rows[0], 1: mono_rows[0]}
    table = {}
    for S, C in sorted(widths):
        table[(S, C)] = _plc_times(f"S{S}_C{C}", _rows_of(base[C], S))
    table["all_lost"] = _plc_times(f"all_lost_S{S_MAIN}_C2", _rows_of(
        base[2], S_MAIN, lost_all=True))
    one = _rows_of(base[2], 1, lost_all=True)
    (consts1, hist1, *rest), kw1 = one
    chain = ((consts1, hist1[:, :1].contiguous(), *rest[:4],
              rest[4][:, :1].contiguous()), kw1)
    table["chain"] = _plc_times("chain_S1_C1", chain)
    return table


# ------------------------------------------- the SILK quantizers (3e)

def nsq_work(params, state, outs, del_dec: bool,
             order: int = silk_nsq.SHAPE_ORDER) -> tuple[int, int]:
    """(bytes, operations) one quantizer call needs on these inputs: each
    input and output tensor read or written once (the rotation Lw of the
    delayed decision once a call); float operations as the plain version
    does them, a sample's for each stream (and trellis state): the LPC
    and shaping dot products, the residual, the pulse decision and the
    updates (the delayed decision adds its two candidates and the warped
    rotation, order^2 + 2 order - 1); the LTP prediction where the stream
    is voiced, the harmonic term where its lag is positive; a subframe's
    scaling of the input, its re-whitening (34 a column) where the
    stream re-whitens and its rescaling where the gain changed. The
    penalties and the replacement's copies are left out."""
    tensors = [*params, *state, *outs[:2], *outs[2]]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    if del_dec:
        nbytes += 4 * order * order
    voiced = params.voiced.cpu().numpy()
    interp = params.interp.cpu().numpy()
    pitch = params.pitch_l.cpu().numpy().astype(np.int64)
    gains = np.maximum(params.gains.cpu().numpy(), 1.0 / 65536)
    prev = state.prev_gain.cpu().numpy()
    lag = np.where(voiced, pitch[:, 0], state.lag_prev.cpu().numpy())
    dot = 31 + 2 * order + 1              # LPC dot, AR dot and tilt
    shared = 3 + 5 + 2 + 4 + 8            # n_lf, residual, decision
    if del_dec:
        per = 4 * (dot + shared + 1 + 1 + 2 + 12 + order * order
                   + 2 * order - 1 + 1) + 2
    else:
        per = dot + shared + 6
    ops = 0
    for k in range(4):
        lag = np.where(voiced, pitch[:, k], lag)
        rewhite = voiced & ((k & np.where(interp, 1, 3)) == 0)
        changed = gains[:, k] != prev
        w = np.minimum(lag + 18, 319)
        seg_end = 320 + 80 * k
        rw = seg_end - np.maximum(seg_end - w + 16, seg_end - lag - 2)
        ops += int((80 * (per + 9 * voiced + 5 * (lag > 0)) + 80 + 2).sum())
        ops += int((34 * rw * rewhite).sum())
        ops += int((changed * (320 + (lag + 2) * (voiced & ~rewhite)
                               + (4 * (98 + order) if del_dec else 42)))
                   .sum())
        prev = gains[:, k]
    return nbytes, ops


def _nsq_row(name, del_dec, kw, args, got, plain_run) -> dict:
    """A quantizer kernel's row at the width of `args`: `got` (the
    kernel's outputs) against the plain version's on the card
    (`plain_run`: its outputs and wall ms) at nsq_cases.held's bars, and
    the kernel's time, bound and share beside the plain version's."""
    want, plain_wall_ms = plain_run
    agree = nsq_cases.agreement(got, want)
    why = nsq_cases.held(agree, del_dec)
    S = args[0].x.shape[0]
    check(why is None, f"{name} at S = {S} against the plain version on "
          f"the card: {why}")
    kernel, plain, _ = nsq_cases.ROUTES[del_dec]
    run = partial(kernel, *args, **kw)
    ms, queued = _event_ms(run, 20)
    nbytes, ops = nsq_work(*args, got, del_dec)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    share = agree["share"]
    return dict(
        shape=[S, 320], ms=ms, events_queued=queued,
        chain_us_a_sample=ms * 1e3 / 320,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=nbytes, operations=ops,
        bound_share=max(t_bytes, t_ops) / ms,
        plain_ms=_device_ms(partial(plain, *args, **kw), reps=1,
                            device_only=True),
        plain_wall_ms=plain_wall_ms, call_wall_ms=_wall_ms(run),
        max_abs_err=float((got[0] - want[0]).abs().max()),
        min_share=float(share.min()), mean_share=float(share.mean()),
        lanes_exactly_equal=agree["exact"],
        state_err_on_exact_lanes=agree["state_err"],
        seeds_equal_on_exact_lanes=agree["seeds_equal"])


def phase_nsq_kernels(dev, widths):
    """The two quantizer kernels (ops/silk_nsq.py) against their plain
    versions on the card. At S = 256: the harvested calls and a copy of
    each voiced one without interpolation (nsq_cases.with_branches) tiled
    over the lanes, every 17th lane unused, and for the delayed decision
    8 lanes tied at every sample; every output bit-equal to the host
    build of the kernels' arithmetic. At every width a path gives a
    kernel (`widths`: kernel -> set of S), the calls spread over the
    lanes, each lane's outputs bit-equal to those of the S = 256 lane
    that holds its call. At each width the pulses, frame, state and seeds
    against the plain version on the card (nsq_cases.held), then the
    kernel's time, bound and share and the plain version's. Returns
    {kernel: {S: row}}."""
    table = {}
    for del_dec, name in ((False, "nsq_frame"), (True, "nsq_del_dec")):
        kernel, plain, host = nsq_cases.ROUTES[del_dec]
        kw = dict(nsq_cases.KW, warping=nsq_cases.WARPING) if del_dec \
            else nsq_cases.KW
        calls = nsq_cases.with_branches(nsq_cases.harvest(del_dec))
        n = len(calls)
        S = S_MAIN
        lanes = np.arange(S) % n
        lanes[::17] = -1
        args = nsq_cases.batch(calls, S, dev, del_dec, lanes=lanes)
        before = _kernel_counts()[name]
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        check(_kernel_counts()[name] == before + 1,
              f"{name}: not one launch a call")
        want, plain_wall_ms = _timed(partial(plain, *args, **kw))
        outs = nsq_cases.flat(got)
        unused = torch.as_tensor(lanes < 0)
        check(torch.equal(outs[0][unused], want[0].cpu()[unused])
              and (not del_dec or torch.equal(outs[1][unused],
                                              want[1].cpu()[unused])),
              f"{name}: an unused lane differs from the plain version")
        firsts = {c: int(np.flatnonzero(lanes == c)[0]) for c in range(n)}
        same = all(torch.equal(t[s], t[firsts[int(c)]]) for t in outs
                   for s, c in enumerate(lanes) if c >= 0)
        check(same, f"{name}: lanes that hold the same call differ")
        ref = host(*nsq_cases.batch(calls, S, "cpu", del_dec, lanes=lanes),
                   **kw)
        host_equal = all(torch.equal(a, b)
                         for a, b in zip(outs, nsq_cases.flat(ref)))
        check(host_equal, f"{name}: the kernel differs from the host build "
              "of its arithmetic")
        tied_lanes = 0
        if del_dec:
            tied = nsq_cases.tied_lanes(8, dev)
            t_got, t_want = kernel(*tied, **kw), plain(*tied, **kw)
            check(torch.equal(t_got[0], t_want[0])
                  and torch.equal(t_got[1], t_want[1]),
                  f"{name}: a tied lane differs from the plain version")
            tied_lanes = 8
        rows = {S: dict(_nsq_row(name, del_dec, kw, args, got,
                                 (want, plain_wall_ms)),
                        calls=n, unused_lanes=int(unused.sum()),
                        tied_lanes=tied_lanes,
                        kernel_equals_host_build=host_equal,
                        ptxas=NSQ_PTXAS.get(name))}
        for W in sorted(widths[name] - {S}):
            w_lanes = (np.arange(W) * n) // W
            w_args = nsq_cases.batch(calls, W, dev, del_dec, lanes=w_lanes)
            w_got = kernel(*w_args, **kw)
            w_outs = nsq_cases.flat(w_got)
            check(all(torch.equal(a, b[[firsts[int(c)] for c in w_lanes]])
                      for a, b in zip(w_outs, outs)),
                  f"{name} at S = {W}: a lane differs from the S = {S} lane "
                  "that holds its call")
            rows[W] = dict(_nsq_row(name, del_dec, kw, w_args, w_got,
                                    _timed(partial(plain, *w_args, **kw))),
                           calls=W, equal_to_the_S256_lanes=True)
        for W, row in sorted(rows.items()):
            say(f"nsq_kernel_{name}_S{W}", **row)
        table[name] = rows
    return table


# ------------------------------------- the device SILK synthesis (3f)

def _strided_copy(t):
    """A copy of t with its strides (a view of a wider plane stays one)."""
    if t is None:
        return None
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def _syn_err(label, got, want) -> float:
    """The largest error of the kernel's output and state planes against
    the plain version's, in units of the frame's peak output; fails past
    SYN_TOL or on a value that is not finite."""
    got, want = (got[0], *got[1]), (want[0], *want[1])
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"{label}: SILK synthesis output not finite")
    peak = max(float(want[0].abs().max()), 1e-30)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want)) / peak
    check(err <= SYN_TOL, f"{label}: the SILK kernel {err} of the peak "
          f"from its plain version (bar {SYN_TOL})")
    return err


@contextlib.contextmanager
def _held_synthesis(label: str, carry: bool):
    """Inside, every silk_synthesis_step of the pipelines runs the kernel
    (the path's own call) and is held to the plain version on the same
    parameters: on the same state (carry=False: the mixed lane, whose
    state is masked afterwards), or on the plain version's own state,
    carried from the first call's (carry=True: SilkStreamPipeline, whose
    state is the step's). Yields {"errs": [each call's error of its
    peak], "first": the first call's arguments, strides kept}."""
    fn = pipeline_mod.silk_synthesis_step
    seen = {"errs": [], "first": None, "plain_state": None}

    def held(params, state, **kw):
        if seen["first"] is None:
            seen["first"] = (
                silk_syn.SilkFrameParams(*map(_strided_copy, params)),
                silk_syn.SilkStreamState(*map(_strided_copy, state)), kw)
            seen["plain_state"] = state
        base = seen["plain_state"] if carry else state
        want = silk_syn.silk_synthesis_step_reference(params, base, **kw)
        before = silk_syn.silk_synthesis_launches
        got = fn(params, state, **kw)
        check(silk_syn.silk_synthesis_launches == before + 1,
              f"{label}: not one kernel launch a step")
        seen["errs"].append(_syn_err(f"{label} call {len(seen['errs'])}",
                                     got, want))
        seen["plain_state"] = want[1]
        return got

    pipeline_mod.silk_synthesis_step = held
    try:
        yield seen
    finally:
        pipeline_mod.silk_synthesis_step = fn


def syn_work(params, state, subfr_len: int) -> tuple[int, int]:
    """(bytes, operations) one silk_synthesis_step call needs on these
    inputs: every parameter and state element read once, the output and
    new state written once; operations a stream: the gain scale (1 a
    sample), the history's re-whitening and ltp_scale (33 a sample), the
    LTP where the stream is voiced (5 products, 5 adds a sample; 1 add
    where it is not), the LPC (16 products, 16 adds a sample), and an
    interpolated frame's second re-whitening (32 a sample of [history |
    first half])."""
    S, L = params.exc.shape
    H = state.out_hist.shape[1]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*params, *state) if t is not None)
    nbytes += 4 * S * (L + H + silk_syn.MAX_D)
    voiced = int(params.voiced.sum())
    interp = 0 if params.interp is None else int(params.interp.sum())
    half = (L // 2 // subfr_len) * subfr_len
    ops = (S * (L + 33 * H + 32 * L) + voiced * 10 * L + (S - voiced) * L
           + interp * 32 * (H + half))
    return nbytes, ops


def _syn_repeats(label, params, state, kw) -> int:
    """The kernel launched SYN_REPEATS times on one call's inputs, every
    launch's output and state planes bit-equal to the host build of its
    arithmetic on CPU copies (strides kept); returns the launches."""
    def cpu(t):
        if t is None:
            return None
        return torch.empty_strided(t.shape, t.stride(),
                                   dtype=t.dtype).copy_(t)

    out, new = silk_syn.silk_synthesis_step_host(
        silk_syn.SilkFrameParams(*map(cpu, params)),
        silk_syn.SilkStreamState(*map(cpu, state)), **kw)
    want = (out, *new)
    for rep in range(SYN_REPEATS):
        out, new = silk_syn.silk_synthesis_step(params, state, **kw)
        check(all(torch.equal(a.cpu(), b)
                  for a, b in zip((out, *new), want)),
              f"{label}: launch {rep} of the SILK kernel differs from the "
              "host build")
    return SYN_REPEATS


def _syn_times(label, params, state, kw, err: float) -> dict:
    """The kernel's device time on one call (torch.profiler), its bound,
    the plain version's device time; `err` the worst error of the
    calls held."""
    run = partial(silk_syn.silk_synthesis_step, params, state, **kw)
    plain = partial(silk_syn.silk_synthesis_step_reference, params, state,
                    **kw)
    nbytes, ops = syn_work(params, state, kw["subfr_len"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    ms = _device_ms(run, match=SYN_KERNEL[1])
    out, _ = run()
    want, _ = plain()
    S, L = params.exc.shape
    row = dict(shape=[S, L], ms=ms,
               plain_ms=_device_ms(plain, reps=2, device_only=True),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, operations=ops,
               chain_us_a_sample=ms * 1e3 / L,
               max_abs_err=float((out - want).abs().max()),
               worst_err_of_peak=err, voiced=int(params.voiced.sum()),
               call_wall_ms=_wall_ms(run),
               launches_equal_to_host_build=_syn_repeats(label, params,
                                                         state, kw))
    row["bound_share"] = row["bound_ms"] / ms
    say(f"silk_synthesis_times_{label}", **row)
    return row


def phase_silk_synthesis_kernel(dev, mono):
    """The device SILK synthesis kernel (ops/silk_synthesis.
    silk_synthesis_step) against its plain version on the card: every
    call of 12 frames of OpusStreamPipeline(256, channels=1,
    silk_synthesis="device") on the mono mix (the lane's own strided
    views), of SilkStreamPipeline(256, synthesis="device") at 16 and 8 kHz
    on the golden SILK streams (stream s starting s % 12 frames in, the
    plain version carrying its own state), and 12 carried frames of
    silk_synthesis_cases.py's seeded 12 kHz streams; then the kernel's
    time at each, and of one stream alone (the chain) at 16, 12 and 8
    kHz, each beside its bound and the plain version's device time, and
    each of these calls launched SYN_REPEATS times, every launch bit-equal
    to the host build. Returns {label: row}."""
    S = S_MAIN
    mixed = partial(frame_batch, mono, S, packets=True)

    def silk(k, f):
        return [mono[k].payloads[(f + s) % SYN_FRAMES] for s in range(S)]

    runs = {
        "mixed_lane": (lambda: OpusStreamPipeline(
            S, channels=1, silk_synthesis="device", device=dev), mixed,
            False),
        "silk16": (lambda: SilkStreamPipeline(
            S, 16, synthesis="device", device=dev), partial(silk, 1), True),
        "silk8": (lambda: SilkStreamPipeline(
            S, 8, synthesis="device", device=dev), partial(silk, 2), True),
    }
    table, held = {}, {}
    for label, (make, batch, carry) in runs.items():
        pipe = make()
        with _held_synthesis(label, carry) as seen:
            for f in range(SYN_FRAMES):
                pipe.step(batch(f))
        torch.cuda.synchronize()
        check(len(seen["errs"]) == SYN_FRAMES,
              f"{label}: {len(seen['errs'])} synthesis calls in "
              f"{SYN_FRAMES} steps")
        held[label] = max(seen["errs"])
        params, state, kw = seen["first"]
        table[label] = _syn_times(label, params, state, kw, held[label])
    # the seeded 12 kHz streams, kernel and plain version each carrying
    # its own state
    khz = 12
    kw = silk_synthesis_cases.step_kwargs(khz)
    frames = silk_synthesis_cases.frames(np.random.default_rng(19), khz,
                                         SYN_FRAMES, S)
    got_state = want_state = silk_syn.init_silk_state(S, khz, dev)
    errs = []
    for f, frame in enumerate(frames):
        params = silk_synthesis_cases.params(frame, dev)
        if f == 0:
            first = (params, got_state)
        got = silk_syn.silk_synthesis_step(params, got_state, **kw)
        want = silk_syn.silk_synthesis_step_reference(params, want_state,
                                                      **kw)
        errs.append(_syn_err(f"seeded12 frame {f}", got, want))
        got_state, want_state = got[1], want[1]
    held["seeded12"] = max(errs)
    table["seeded12"] = _syn_times("seeded12", *first, kw, held["seeded12"])
    # one stream alone: a voiced stream with interpolated halves
    for khz in SYN_CHAIN_KHZ:
        frame = silk_synthesis_cases.frames(np.random.default_rng(20), khz,
                                            1)[0]
        one = silk_synthesis_cases.params(
            {k: v[1:2] for k, v in frame.items()}, dev)
        label = "chain_S1" if khz == 16 else f"chain{khz}_S1"
        table[label] = _syn_times(
            label, one, silk_syn.init_silk_state(1, khz, dev),
            silk_synthesis_cases.step_kwargs(khz), 0.0)
    say("silk_synthesis_kernel", worst_err_of_peak=held, bar=SYN_TOL,
        frames=SYN_FRAMES, repeats=SYN_REPEATS, ptxas=SYN_PTXAS)
    return table


# ------------------------------------------ the neural recovery kernels

def _lanes(x, idx, cpu: bool = False):
    """x (a tensor of streams, or a tuple or state of them) at the streams
    idx (on the CPU where `cpu`)."""
    if isinstance(x, torch.Tensor):
        return x[idx].cpu() if cpu else x[idx]
    items = [_lanes(v, idx, cpu) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _rdovae_flat(state):
    """An RdovaeDecState as one (S, n) tensor: the GRU states, then each
    conv's past inputs oldest first."""
    return torch.cat([*state.gru_states, *(p for c in state.conv_states
                                           for p in c.past)], dim=1)


def conceal_work(model, pitch_model, S: int, F: int,
                 hold: bool) -> tuple[int, int]:
    """(bytes, operations) one conceal_frames call needs: both models'
    weights, the features, the state and the flags read once, the PCM, the
    periods and the new state written once; 2 operations a weight a row
    applied: a frame's conditioning layers (the gain's dense once a frame,
    as the kernel computes it), its subframe layers 4 times, PitchDNN once
    a frame (once a call where `hold`). The activations and the element
    work (under 1% of these) are left out."""
    dims = fargan.layer_dims()
    once = ("cond_fdense1", "cond_fconv1", "cond_fdense2", "cond_gain_dense")
    frame = sum(4 ** (name not in once) * i * o for name, (i, o)
                in dims.items())
    pitch = sum(i * o for i, o in fargan.PITCH_DIMS)
    ops = 2 * S * (F * frame + (1 if hold else F) * pitch)
    weights = sum(p.numel() for m in (model, pitch_model)
                  for p in m.parameters())
    state = 256 + 256 + 3 * 128 + 1 + 64
    nbytes = 4 * (weights + S * (20 * (1 if hold else F) + 1 + 2 * state
                                 + F * (160 + 1)))
    return nbytes, ops


def rdovae_work(model, S: int, Q: int) -> tuple[int, int]:
    """(bytes, operations) one decode_qframes call needs: the decoder's
    weights and the packed rows read once, the features written once; 2
    operations a weight a row applied: the initial state's two layers
    once, the qframe's layers Q times (inactive qframes' outputs are
    computed too). Activations left out."""
    layers = rdovae.kernel_layers(model)
    macs = [layer.weight.numel() for layer in layers]
    ops = 2 * S * (sum(macs[:2]) + Q * sum(macs[2:]))
    weights = sum(p.numel() for p in model.parameters())
    nbytes = 4 * (weights + S * (rdovae.packed_width(Q) + Q * 80))
    return nbytes, ops


def _neural_row(label, kernel, run, plain, work, err, **extra) -> dict:
    """One call's times on the card: the kernel's device time
    (torch.profiler, and CUDA events), its bound, the plain version's
    device time, both calls' host wall ms; `err` the worst error of the
    calls held."""
    nbytes, ops = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    ms = _device_ms(run, reps=10, match=NEURAL_KERNELS[kernel][1])
    event_ms, queued = _event_ms(run, 10)
    row = dict(ms=ms, event_ms=event_ms, event_queued=queued,
               plain_ms=_device_ms(plain, reps=2, device_only=True),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, operations=ops, max_abs_err=err,
               call_wall_ms=_wall_ms(run), plain_call_wall_ms=_wall_ms(plain),
               **extra)
    row["bound_share"] = row["bound_ms"] / ms
    say(f"neural_times_{label}", **row)
    return row


def _conceal_held(label, got, want, flipped) -> float:
    """A conceal_frames call of the kernel (got) against the plain version
    on the same inputs (want): integer periods equal, or flipped only
    within PERIOD_TOL of an integer (the lane is marked in `flipped` and
    left out from then on); PCM within NEURAL_PCM_TOL and every state
    field within NEURAL_PCM_TOL of its scale. Returns the worst PCM
    error."""
    pg, pc = got[1].cpu().numpy(), want[1].cpu().numpy()
    for s, f in zip(*np.nonzero(pg.astype(np.int32) != pc.astype(np.int32))):
        dist = float(abs(pc[s, f] - np.round(pc[s, f])))
        print(f"[neural_kernels] {label}: period flip lane {s} frame {f} "
              f"card {pg[s, f]} plain {pc[s, f]}", flush=True)
        check(dist < PERIOD_TOL, f"{label}: period flip far from an "
              f"integer ({dist})")
        flipped[s] = True
    check(bool(torch.isfinite(got[0]).all()), f"{label}: PCM not finite")
    keep = torch.as_tensor(~flipped, device=got[0].device)

    def worst(a, b) -> float:
        d = (a - b).abs()[keep]
        return float(d.max()) if d.numel() else 0.0

    err = worst(got[0], want[0])
    check(err <= NEURAL_PCM_TOL, f"{label}: PCM {err} from the plain "
          "version")
    for name, g, w in zip((*fargan.FarganState._fields, "pitch_state"),
                          (*got[2], got[3]), (*want[2], want[3])):
        if not w.numel():       # fwc0_mem: no history
            continue
        d = worst(g, w)
        check(d <= NEURAL_PCM_TOL * max(1.0, float(w.abs().max())),
              f"{label}: state {name} {d} from the plain version")
    return err


def _conceal_host_equal(label, cpu_models, state, feats, active, got,
                        lanes, frames=None) -> int:
    """The kernel's outputs (got) on the streams `lanes` bit-equal to the
    host build's on CPU copies of those streams' inputs; returns the
    streams checked."""
    idx = torch.as_tensor(list(lanes))
    host = fargan.conceal_frames_host(
        *cpu_models, *_lanes(state, idx, cpu=True),
        feats[idx].cpu(), None if active is None else active[idx].cpu(),
        frames)
    for a, b in zip((got[0], got[1], *got[2], got[3]),
                    (host[0], host[1], *host[2], host[3])):
        check(torch.equal(a[idx].cpu(), b), f"{label}: the kernel differs "
              "from the host build")
    return len(idx)


def phase_neural_kernels(dev):
    """The neural recovery's kernels against their plain versions on the
    card, on the port's seeded models (FARGAN seed 2, PitchDNN 3, RDOVAE
    decoder 1): conceal_frames at S = 64 and 256 on the bench's features,
    NEURAL_CALLS calls with the state carried (kernel and plain version
    each carrying its own), the DeepPlcState route at S = 1 (two calls of
    320 samples), decode_qframes on _seeded_dreds(64) (lanes cut short at
    different qframes) and on one stream alone. Each call: one launch,
    within the bars of phase 15 (integer periods equal or flipped within
    1e-3 of an integer, PCM and state within 1e-4) or 1e-4 of the
    features' scale, bit-equal to the host build (every stream at S = 64
    and 1 and in the first call at 256, NEURAL_HOST_STREAMS streams of
    the others), a stream bit-equal alone at S = 1. Then each call's
    device time beside its bound and the plain version's. Returns {label:
    row}."""
    t0 = time.perf_counter()

    def seeded(seed, make, device):
        return make(torch.Generator().manual_seed(seed), device=device)

    fm, pm, dm = (seeded(2, fargan.random_model, dev),
                  seeded(3, deep_plc.random_pitchdnn, dev),
                  seeded(1, rdovae.random_dec, dev))
    cpu_models = (seeded(2, fargan.random_model, "cpu"),
                  seeded(3, deep_plc.random_pitchdnn, "cpu"))
    table, held = {}, {}
    for S in (S_NEURAL, 256):
        feats = torch.as_tensor(_bench_features(S), device=dev)
        first = state = plain = (fargan.init_state(fm, S),
                                 torch.zeros(S, 64, device=dev))
        flipped, errs, checked = np.zeros(S, bool), [], 0
        for call in range(NEURAL_CALLS):
            label = f"conceal S={S} call {call}"
            fargan.reset_launches()
            got = fargan.conceal_frames(fm, pm, *state, feats)
            check(fargan.conceal_frames_launches == 1,
                  f"{label}: {fargan.conceal_frames_launches} launches")
            want = fargan.conceal_frames_reference(fm, pm, *plain, feats)
            errs.append(_conceal_held(label, got, want, flipped))
            lanes = (range(S) if S == S_NEURAL or call == 0
                     else range(0, S, S // NEURAL_HOST_STREAMS))
            checked += _conceal_host_equal(label, cpu_models, state, feats,
                                           None, got, lanes)
            one = fargan.conceal_frames(fm, pm, *_lanes(state, [17]),
                                        feats[17:18])
            check(all(torch.equal(a[0], b[17]) for a, b in zip(
                (one[0], one[1], *one[2], one[3]),
                (got[0], got[1], *got[2], got[3]))),
                f"{label}: stream 17 alone differs from its batch")
            state, plain = (got[2], got[3]), (want[2], want[3])
        held[f"conceal_S{S}"] = max(errs)
        table[f"conceal_S{S}"] = _neural_row(
            f"conceal_S{S}", "fargan_conceal",
            partial(fargan.conceal_frames, fm, pm, *first, feats),
            partial(fargan.conceal_frames_reference, fm, pm, *first, feats),
            conceal_work(fm, pm, S, 2, False), max(errs), shape=[S, 2],
            calls=NEURAL_CALLS, lanes_with_flips=int(flipped.sum()),
            stream_frames_equal_to_host_build=2 * checked)
    # the DeepPlcState route: PitchDNN once, two frames a call
    plc = deep_plc.DeepPlcState(fm, pm, device=dev)
    plc.last_features = _bench_features(1)[0, 0]
    f1 = torch.as_tensor(plc.last_features[None], device=dev)
    plain = (fargan.init_state(fm, 1), torch.zeros(1, 64, device=dev))
    flipped, errs = np.zeros(1, bool), []
    for call in range(2):
        before = (plc.fargan_state or fargan.init_state(fm, 1),
                  plc.pitch_state)
        fargan.reset_launches()
        pcm = plc.conceal(2 * 160)
        check(fargan.conceal_frames_launches == 1,
              f"DeepPlcState.conceal: {fargan.conceal_frames_launches} "
              "launches")
        got = (torch.as_tensor(pcm[None], device=dev),
               plc.last_period[:, None].expand(1, 2), plc.fargan_state,
               plc.pitch_state)
        want = fargan.conceal_frames_reference(fm, pm, *plain, f1, frames=2)
        errs.append(_conceal_held(f"deep_plc call {call}", got, want,
                                  flipped))
        _conceal_host_equal(f"deep_plc call {call}", cpu_models, before, f1,
                            None, got, [0], frames=2)
        plain = (want[2], want[3])
    table["deep_plc_S1"] = _neural_row(
        "deep_plc_S1", "fargan_conceal",
        partial(fargan.conceal_frames, fm, pm, fargan.init_state(fm, 1),
                torch.zeros(1, 64, device=dev), f1, frames=2),
        partial(fargan.conceal_frames_reference, fm, pm,
                fargan.init_state(fm, 1), torch.zeros(1, 64, device=dev), f1,
                frames=2),
        conceal_work(fm, pm, 1, 2, True), max(errs), shape=[1, 2])
    # the RDOVAE decode on seeded DRED payloads, and one stream alone
    packed_np, n10 = rdovae.pack_latents(_seeded_dreds(S_NEURAL),
                                         dred.synthetic_stats())
    packed = torch.from_numpy(packed_np).to(dev)
    Q = int(n10.max()) // 4
    rdovae.reset_launches()
    got, got_st = rdovae.decode_qframes(dm, packed, return_state=True)
    check(rdovae.decode_qframes_launches == 1,
          f"decode_qframes: {rdovae.decode_qframes_launches} launches")
    want, want_st = rdovae.decode_qframes_reference(dm, packed,
                                                    return_state=True)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= 1e-4 * scale,
          f"RDOVAE features {err} from the plain version (bar 1e-4 * "
          f"{scale})")
    st_err = float((_rdovae_flat(got_st) - _rdovae_flat(want_st)).abs()
                   .max())
    check(st_err <= 1e-4 * max(1.0, float(_rdovae_flat(want_st).abs()
                                          .max())),
          f"RDOVAE final state {st_err} from the plain version")
    host, host_st = rdovae.decode_qframes_host(
        seeded(1, rdovae.random_dec, "cpu"), torch.from_numpy(packed_np),
        return_state=True)
    check(torch.equal(got.cpu(), host) and torch.equal(
        _rdovae_flat(got_st).cpu(), _rdovae_flat(host_st)),
        "the RDOVAE kernel differs from the host build")
    for s in (0, 17, S_NEURAL - 1):
        one = rdovae.decode_qframes(dm, packed[s:s + 1])
        check(torch.equal(one[0], got[s]),
              f"RDOVAE stream {s} alone differs from its batch")
    for label, rows in (("rdovae_S64", packed), ("rdovae_S1", packed[:1])):
        table[label] = _neural_row(
            label, "rdovae_decode", partial(rdovae.decode_qframes, dm, rows),
            partial(rdovae.decode_qframes_reference, dm, rows),
            rdovae_work(dm, rows.shape[0], Q), err, shape=[rows.shape[0], Q],
            qframes_active_min=int(n10.min()) // 4)
    say("neural_kernels", worst_pcm_err=held, rdovae_err=err,
        rdovae_bar=1e-4 * scale, rdovae_state_err=st_err,
        bar=NEURAL_PCM_TOL, ptxas=NEURAL_PTXAS,
        seconds=round(time.perf_counter() - t0, 2))
    return table


def phase_main_path(dev, streams):
    S, F = S_MAIN, 12
    pipe = CeltStreamPipeline(S, channels=2, use_plan=True, device=dev)
    _reset_launches()
    worst = 0.0
    launches, leaf_after = [], []
    for f in range(F):
        pcm = pipe.step(frame_batch(streams, S, f), FRAME)
        torch.cuda.synchronize()
        launches.append(deemph.deemphasis_launches)
        leaf_after.append(_kernel_counts())
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 2), f"pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        err = np.abs(got - golden_pcm(streams, S, f)).max(axis=(1, 2))
        check(bool((err <= GOLDEN_TOL).all()),
              f"frame {f}: {int((err > GOLDEN_TOL).sum())} streams beyond "
              f"{GOLDEN_TOL}, worst {err.max()}")
        worst = max(worst, float(err.max()))
    n = deemph.deemphasis_launches
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per step {launches}: one a step expected")
    leaf = _path_launches("celt", F, after_each=leaf_after)
    # the arena is staged in page-locked memory, so its copy is asynchronous
    arena = pipe._native._plan_db[FRAME][1][0][0]["backing"]
    pinned = torch.from_numpy(arena).is_pinned()
    check(pinned, "the plan arena is not in page-locked memory")
    say("main_path", streams=S, frames=F, worst_abs_err_vs_golden=worst,
        bar=GOLDEN_TOL, deemphasis_launches=n,
        launches_after_each_step=launches, kernel_launches=leaf,
        arena_pinned=pinned)
    return n, worst


def _loss_phase(phase, dev, make_pipe, batch_fn):
    """S = 256 streams with ~10% seeded packet loss on the card; the first
    8 streams against the same pipeline run on the CPU, and all 256
    against the same streams as the first 256 of a batch of 1024 (the
    others with their own loss), every lane within BATCH_TOL."""
    S, F, K = S_MAIN, 12, 8
    rng = np.random.default_rng(17)
    lost = rng.random((S_WIDE, F)) < 0.10
    lost[:, 0] = False
    lost[1, 5:7] = True
    gpu = make_pipe(S, dev)
    wide = make_pipe(S_WIDE, dev)
    cpu = make_pipe(K, "cpu")
    worst_rx, worst_lost, worst_wide = 0.0, 0.0, 0.0
    for f in range(F):
        batch = batch_fn(S_WIDE, f, lost[:, f])
        with _plc_label(phase):
            got = gpu.step(batch[:S]).cpu().numpy()
            wide_pcm = wide.step(batch)[:S].cpu().numpy()
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        worst_wide = max(worst_wide, float(np.abs(wide_pcm - got).max()))
        want = cpu.step(batch[:K]).numpy()
        for s in range(K):
            err = float(np.abs(got[s] - want[s]).max())
            plc = bool(lost[s, f] or (f and lost[s, f - 1]))
            check(err < (5e-3 if plc else 2e-4),
                  f"{phase} frame {f} stream {s}: {err} "
                  f"(lost={lost[s, f]})")
            if plc:
                worst_lost = max(worst_lost, err)
            else:
                worst_rx = max(worst_rx, err)
    check(worst_wide <= BATCH_TOL,
          f"{phase}: {worst_wide} between S = {S} and the first {S} of "
          f"S = {S_WIDE}")
    launches = _plc_held(phase, [(S, gpu.channels), (S_WIDE, gpu.channels)])
    say(phase, streams=S, frames=F, loss_share=float(lost[:S].mean()),
        plc_rows_launches=launches,
        compared_streams=K, worst_err_received=worst_rx,
        worst_err_concealed=worst_lost,
        worst_err_vs_first_of_wide_batch=worst_wide, wide_streams=S_WIDE,
        bar=BATCH_TOL)


def _batch_stages(phase, make_pipe, batch_fn, n_frames, share, seed,
                  first_loss):
    """16 lossy streams as one batch, as 8 batches of 2 and as 5 + 11
    (batch_stages.split_errors): every lane within BATCH_TOL; each
    stage's worst error and the first stage that differs printed."""
    S = 16
    frames, lost = batch_stages.lossy_frames(batch_fn, S, n_frames, share,
                                             seed, first_loss)
    check(bool(lost.any()), f"{phase}: no loss drawn")
    with _plc_label(f"{phase}_batch"):
        res = batch_stages.split_errors(make_pipe, frames, S,
                                        {"8x2": (2,) * 8, "5+11": (5, 11)})
    for label in ("8x2", "5+11"):
        r = res[label]
        say(f"{phase}_batch_{label}", streams=S, frames=n_frames,
            worst_pcm_err=r["pcm"], first_difference=r["first"],
            **{f"stage_{k}": v for k, v in r["stages"].items()})
        check(r["pcm"] <= BATCH_TOL,
              f"{phase}: {r['pcm']} between S = {S} and batches {label}")


def phase_loss(dev, streams):
    _loss_phase("loss", dev,
                lambda S, d: CeltStreamPipeline(S, use_plan=True, device=d),
                partial(frame_batch, streams))
    _batch_stages("loss", lambda n: CeltStreamPipeline(n, use_plan=True,
                                                       device=dev),
                  partial(frame_batch, streams), 4, 0.3, 5, 2)


def phase_mixed_loss(dev, mono):
    _loss_phase("mixed_loss", dev,
                lambda S, d: OpusStreamPipeline(S, channels=1, device=d),
                partial(frame_batch, mono, packets=True))
    _batch_stages("mixed_loss",
                  lambda n: OpusStreamPipeline(n, channels=1, device=dev),
                  partial(frame_batch, mono, packets=True), 3, 0.15, 31, 1)


def phase_celt_modes(dev, streams):
    """The scanned decode, the chunked stream and the threaded host overlap
    against the stepped output at S = 256 (equal exactly), and the
    non-plan path against the golden PCM."""
    with _plc_label("celt_modes"):
        _celt_modes(dev, streams)
    _plc_held("celt_modes", [(S_MAIN, 2)])


def _celt_modes(dev, streams):
    S, F = S_MAIN, 8
    lost = np.zeros((S, F), bool)
    lost[::9, 7] = True                      # concealment inside a chunk
    frames = [frame_batch(streams, S, f, lost[:, f]) for f in range(F)]
    stepped = CeltStreamPipeline(S, use_plan=True, device=dev)
    want = [stepped.step(batch) for batch in frames]

    def run(mode):
        pipe = CeltStreamPipeline(S, use_plan=True, device=dev)
        if mode == "scanned":
            return list(pipe.decode_frames_scanned(frames))
        if mode == "chunk4":
            return list(pipe.decode_stream(iter(frames), chunk=4))
        pipe.overlap_host = True
        return list(pipe.decode_stream(iter(frames)))

    diffs = {}
    for mode in ("scanned", "chunk4", "overlap_host"):
        got = run(mode)
        check(len(got) == F, f"{mode}: {len(got)} frames of {F}")
        diffs[mode] = max(float((g - w).abs().max())
                          for g, w in zip(got, want))
        check(diffs[mode] == 0.0,
              f"{mode} differs from stepped output by {diffs[mode]}")
    nonplan = CeltStreamPipeline(S, use_plan=False, device=dev)
    worst = 0.0
    for f in range(F):
        got = nonplan.step(frame_batch(streams, S, f)).cpu().numpy()
        worst = max(worst,
                    float(np.abs(got - golden_pcm(streams, S, f)).max()))
    check(worst <= GOLDEN_TOL, f"non-plan path: {worst} from the golden PCM")
    say("celt_modes", streams=S, frames=F,
        **{f"max_abs_diff_{m}": d for m, d in diffs.items()},
        non_plan_worst_abs_err_vs_golden=worst)


def phase_mixed_main(dev, mono):
    S, F = S_MAIN, 12
    pipe = OpusStreamPipeline(S, channels=1, device=dev)
    _reset_launches()
    worst = 0.0
    launches, leaf_after = [], []
    modes = set()
    for f in range(F):
        pcm = pipe.step(frame_batch(mono, S, f, packets=True))
        torch.cuda.synchronize()
        launches.append(deemph.deemphasis_launches)
        leaf_after.append(_kernel_counts())
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 1), f"mixed pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        modes |= set(int(m) for m in pipe.last_modes)
        err = np.abs(got - golden_pcm(mono, S, f)).max(axis=(1, 2))
        held = np.array([f >= MIX_GOLDEN_FROM.get(mono[s % len(mono)].name, 0)
                         for s in range(S)])
        check(bool((err[held] <= GOLDEN_TOL).all()),
              f"mixed frame {f}: {int((err[held] > GOLDEN_TOL).sum())} "
              f"streams beyond {GOLDEN_TOL}, worst {err[held].max()}")
        worst = max(worst, float(err[held].max()))
    n = deemph.deemphasis_launches
    check(modes == {0, 1, 2}, f"modes seen {modes}: CELT, SILK and hybrid "
          "expected")
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per mixed step {launches}: one expected")
    leaf = _path_launches("mixed", F, after_each=leaf_after)
    say("mixed_main_path", streams=S, frames=F, modes=sorted(modes),
        worst_abs_err_vs_golden=worst, bar=GOLDEN_TOL,
        deemphasis_launches=n, launches_after_each_step=launches,
        kernel_launches=leaf)
    return n


def phase_device_silk(dev, mono):
    """The device SILK synthesis against the bit-exact host synthesis."""
    S, F = S_MAIN, 12
    payloads = mono[1].payloads                       # silk_wb_16k
    host = SilkStreamPipeline(S, synthesis="host", device=dev)
    device = SilkStreamPipeline(S, synthesis="device", device=dev)
    a, b = [], []
    _reset_launches()
    for f in range(F):
        a.append(host.step([payloads[f]] * S).cpu().numpy())
        b.append(device.step([payloads[f]] * S).cpu().numpy())
    SYN_LAUNCHES["silk_device"] = (silk_syn.silk_synthesis_launches,
                                   "silk16")
    a, b = np.concatenate(a, axis=1), np.concatenate(b, axis=1)
    check(bool(np.isfinite(b).all()), "non-finite device SILK pcm")
    snr = 10 * np.log10((a ** 2).mean(axis=1)
                        / (((a - b) ** 2).mean(axis=1) + 1e-12))
    check(float(snr.min()) > 45.0, f"device SILK SNR {snr.min()} dB <= 45")
    lane = OpusStreamPipeline(S, silk_synthesis="device", device=dev)
    plain = OpusStreamPipeline(S, device=dev)
    worst = 0.0
    _reset_launches()
    for f in range(F):
        batch = frame_batch(mono, S, f, packets=True)
        got = lane.step(batch)
        check(5 in set(int(m) for m in lane.last_modes),
              "no stream rode the device-SILK lane")
        worst = max(worst, float((got - plain.step(batch)).abs().max()))
    SYN_LAUNCHES["mixed_device_silk"] = (silk_syn.silk_synthesis_launches,
                                         "mixed_lane")
    check(worst < 5e-3, f"device-SILK lane {worst} from the host lane")
    for path, (n, _) in SYN_LAUNCHES.items():
        check(n == F, f"{path}: {n} SILK synthesis launches in {F} steps: "
              "one a step expected")
    say("device_silk", streams=S, frames=F, min_snr_db=float(snr.min()),
        lane_worst_abs_err_vs_host_lane=worst,
        silk_synthesis_launches={k: v[0] for k, v in SYN_LAUNCHES.items()})


def _time_stream(pipe, batch_fn, warm=3, steps=12, **kwargs):
    """Steady-state ms/step of pipe.decode_stream(**kwargs) over `steps`
    frames after `warm`."""
    def frames(n, first):
        return (batch_fn((first + i) % 12) for i in range(n))

    for _ in pipe.decode_stream(frames(warm, 0), **kwargs):
        pass
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for _ in pipe.decode_stream(frames(steps, warm), **kwargs):
        n += 1
    torch.cuda.synchronize()
    check(n == steps, f"{n} frames of {steps} came out")
    return (time.perf_counter() - t0) * 1e3 / n


# record_function spans of the port
RANGES = ("host.", "mesh.", "plan.", "plc.", "synthesis.", "silk.",
          "mixed.", "front.", "nsq.", "pitchdnn", "fargan.", "rdovae.")
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")


def _innermost_range(ev):
    while ev is not None:
        if ev.name.startswith(RANGES):
            return ev.name
        ev = ev.cpu_parent
    return "outside"


def _profile_step(step, tag=None):
    """One call of `step` under torch.profiler: kernel launches (host-side
    launch calls, attributed to the innermost port span), device busy time
    (sum of kernel durations) and host time by span. With a tag (and
    --out) the profiler's table goes to profile_<tag>.txt."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    counts_before = _kernel_counts()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    leaf = {k: v - counts_before[k] for k, v in _kernel_counts().items()}
    launches: dict = {}
    host_ms: dict = {}
    device_us = 0.0
    kernels = 0
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    for ev in prof.events():
        if ev.device_type == cpu and ev.name in LAUNCH_CALLS:
            stage = _innermost_range(ev.cpu_parent)
            launches[stage] = launches.get(stage, 0) + 1
        elif ev.device_type == cpu and ev.name.startswith(RANGES):
            host_ms[ev.name] = round(host_ms.get(ev.name, 0.0)
                                     + ev.cpu_time_total / 1e3, 3)
        elif ev.device_type == cuda and not ev.name.startswith(RANGES):
            kernels += 1
            device_us += ev.time_range.elapsed_us()
    if OUT_DIR is not None and tag is not None:
        with open(os.path.join(OUT_DIR, f"profile_{tag}.txt"), "w") as fh:
            fh.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=40))
    return {"launches": sum(launches.values()), "device_kernels": kernels,
            "device_busy_ms": round(device_us / 1e3, 3),
            "profiled_wall_ms": round(wall_ms, 3),
            "kernel_launches": leaf,
            "launches_by_span": launches, "host_ms_by_span": host_ms}


def _profile(name, step_of_frame):
    """One profiled step (of frame 5). The profiler is warm from phase 3
    on, and the pipeline has run steps before. A step with a launch
    budget (MAX_STEP_LAUNCHES) is held to it."""
    prof = _profile_step(partial(step_of_frame, 5), name)
    say(f"profile_{name}", **prof)
    if name in MAX_STEP_LAUNCHES:
        check(prof["launches"] <= MAX_STEP_LAUNCHES[name],
              f"profiled step {name}: {prof['launches']} launches, at most "
              f"{MAX_STEP_LAUNCHES[name]} expected")
    return prof


def phase_timing(dev, streams, mono):
    for S in (S_MAIN, S_WIDE):
        celt_batch = partial(frame_batch, streams, S)
        mixed_batch = partial(frame_batch, mono, S, packets=True)
        pipe = CeltStreamPipeline(S, use_plan=True, device=dev)
        mixed = OpusStreamPipeline(S, channels=1, device=dev)
        modes = {f"S{S}": (pipe, celt_batch, {}),
                 f"mixed_S{S}": (mixed, mixed_batch, {})}
        if S == S_MAIN:
            lane = OpusStreamPipeline(S, silk_synthesis="device", device=dev)
            modes["mixed_S256_device_silk"] = (lane, mixed_batch, {})
            overlapped = CeltStreamPipeline(S, use_plan=True, device=dev)
            overlapped.overlap_host = True
            modes["S256_overlap_host"] = (overlapped, celt_batch, {})
            modes["S256_chunk4"] = (
                CeltStreamPipeline(S, use_plan=True, device=dev),
                celt_batch, {"chunk": 4})
        # the modes take turns, so that a slow stretch of the shared host
        # does not fall on one of them alone
        runs: dict = {name: [] for name in modes}
        # the wide runs are timed once: with more the whole script took
        # over 900 s of its 1200 on a slow host
        for rep in range(TIMING_REPEATS if S == S_MAIN else 1):
            for name, (p, batch_fn, kwargs) in modes.items():
                runs[name].append(_time_stream(
                    p, batch_fn, warm=1 if rep else 3, steps=TIMING_STEPS,
                    **kwargs))
        for name, ms in runs.items():
            median = float(np.median(ms))
            say(f"timing_{name}", streams=S, ms_per_step=median,
                ms_per_step_min=min(ms), ms_per_step_runs=ms,
                realtime_x=S * 0.02 / (median / 1e3), **modes[name][2])
        _profile(f"S{S}", lambda f: pipe.step(celt_batch(f)))
        _profile(f"mixed_S{S}", lambda f: mixed.step(mixed_batch(f)))
        if S == S_MAIN:
            lost = np.zeros(S, bool)
            lost[::10] = True
            with _plc_label("timing"):
                lossy = _profile_step(lambda: pipe.step(celt_batch(6, lost)),
                                      "S256_lossy")
                mixed_lossy = _profile_step(
                    lambda: mixed.step(mixed_batch(6, lost)),
                    "mixed_S256_lossy")
            for name, prof in (("S256_lossy", lossy),
                               ("mixed_S256_lossy", mixed_lossy)):
                say(f"profile_{name}", **prof)
                check(prof["kernel_launches"]["plc_rows"] == 1
                      and prof["launches"] <= MAX_STEP_LAUNCHES[name],
                      f"profiled {name} step: {prof['launches']} launches, "
                      f"plc_rows {prof['kernel_launches']['plc_rows']}")
            prof = _profile("mixed_S256_device_silk",
                            lambda f: lane.step(mixed_batch(f)))
            silk = SilkStreamPipeline(S, synthesis="device", device=dev)
            payloads = mono[1].payloads
            for f in range(4):
                silk.step([payloads[f]] * S)
            silk_prof = _profile("silk_S256_device",
                                 lambda f: silk.step([payloads[f]] * S))
            for name, p in (("mixed_S256_device_silk", prof),
                            ("silk_S256_device", silk_prof)):
                spans = p["launches_by_span"]
                check(p["kernel_launches"]["silk_synthesis"] == 1
                      and not spans.get("silk.ltp")
                      and not spans.get("silk.lpc"),
                      f"profiled {name} step: silk_synthesis launched "
                      f"{p['kernel_launches']['silk_synthesis']} times, "
                      f"spans {spans}")


# ------------------------------------------------------------ encode side

def _pcm_batch(streams, S, f):
    """(S, 960, channels) float32 input of frame f: the golden PCM."""
    return golden_pcm(streams, S, f % 12)


def phase_encode_front(dev, streams):
    """front_step on the card against the same function on the CPU: the
    card runs 256 streams, the CPU the three distinct ones."""
    S, F, K = S_MAIN, 12, len(streams)
    consts = {d: encode_front.make_front_consts(FRAME, d)
              for d in (dev, "cpu")}
    st_g = encode_front.init_front_state(S, 2, FRAME, dev)
    st_c = encode_front.init_front_state(K, 2, FRAME, "cpu")
    nby = torch.full((S,), 320, dtype=torch.int32)
    worst = {"freq_rel": 0.0, "floats": 0.0}
    for f in range(F):
        pcm = torch.from_numpy(_pcm_batch(streams, S, f))
        tapset = ((torch.arange(S) % K + f) % 3).to(torch.int32)
        got, st_g = encode_front.front_step(
            consts[dev], st_g, pcm.to(dev), nby.to(dev), tapset.to(dev))
        want, st_c = encode_front.front_step(
            consts["cpu"], st_c, pcm[:K], nby[:K], tapset[:K])
        lane = torch.arange(S) % K
        for key, w in want.items():
            g, w = got[key].cpu(), w[lane]
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"front {key}: {g.shape} {g.dtype} on the card")
            if not g.is_floating_point():
                check(bool((g == w).all()),
                      f"front frame {f}: {key} differs in "
                      f"{int((g != w).sum())} streams")
            elif key == "freq":
                rel = float((g - w).abs().max() / w.abs().max())
                check(rel <= 1e-4, f"front frame {f}: freq off by {rel}")
                worst["freq_rel"] = max(worst["freq_rel"], rel)
            else:
                check(bool(torch.isfinite(g).all()), f"front {key} not finite")
                err = float((g - w).abs().max())
                check(err <= 1e-4, f"front frame {f}: {key} off by {err}")
                worst["floats"] = max(worst["floats"], err)
    say("encode_front", streams=S, frames=F,
        worst_freq_rel_err=worst["freq_rel"],
        worst_float_output_err=worst["floats"], bar=1e-4,
        integer_outputs="equal")


def _encode_round_trip(device, streams, S, chunk=None):
    """Encode the 12 golden frames (step(), or encode_stream() in chunks),
    decode the packets with the port's CELT decoder on the same device.
    Returns (packets [frame][stream], decoded (S, 12 * 960, 2))."""
    F = 12
    enc = CeltEncodePipeline(S, channels=2, bitrate=ENCODE_BITRATE,
                             device=device)
    if chunk is None:
        frames = [enc.step(_pcm_batch(streams, S, f)) for f in range(F)]
    else:
        frames = list(enc.encode_stream(
            np.stack([_pcm_batch(streams, S, f)
                      for f in range(c, c + chunk)])
            for c in range(0, F, chunk)))
    check(len(frames) == F, f"{len(frames)} encoded frames of {F}")
    if chunk is not None and enc.device.type == "cuda":
        # the read-back of a chunk lands in page-locked memory: a ring of
        # two buffer sets, each waited on by its event before it is read
        sets = enc._d2h._sets
        check(all(s is not None and all(h.is_pinned() for h in s)
                  for s in sets), "the encoder's read-back is not pinned")
    dec = CeltStreamPipeline(S, channels=2, use_plan=True,
                              device=device)
    out = []
    for pkts in frames:
        check(len(pkts) == S and all(p is not None and len(p) > 10
                                     for p in pkts),
              "an encoded packet is empty")
        out.append(dec.step(pkts, FRAME).cpu().numpy())
    return frames, np.concatenate(out, axis=1)


def phase_encode_celt(dev, streams):
    """The encode main path: 256 stereo streams encoded on the card,
    decoded on the card, held to the input. The bar of each fixture is the
    SNR of the same round trip through the port on the CPU (one stream a
    fixture, made in this run) less ENCODE_SNR_MARGIN_DB."""
    S, K = S_MAIN, len(streams)
    result = {}
    for mode, chunk in (("step", None), ("stream4", 4)):
        frames, decoded = _encode_round_trip(dev, streams, S, chunk)
        cpu_frames, cpu_decoded = _encode_round_trip("cpu", streams, K, chunk)
        check(bool(np.isfinite(decoded).all()), "non-finite decoded pcm")
        cpu_snr = {g.name: quality.snr_db(g.pcm, cpu_decoded[s])
                   for s, g in enumerate(streams)}
        snr = {}
        for s in range(S):
            g = streams[s % K]
            val = quality.snr_db(g.pcm, decoded[s])
            bar = cpu_snr[g.name] - ENCODE_SNR_MARGIN_DB
            check(val >= bar, f"encode {mode}: stream {s} ({g.name}) "
                  f"{val:.2f} dB under its bar {bar:.2f}")
            snr[g.name] = min(snr.get(g.name, 1e9), val)
        equal = sum(frames[f][s] == cpu_frames[f][s % K]
                    for f in range(12) for s in range(S))
        result[mode] = dict(
            min_snr_db_by_fixture=snr, cpu_snr_db_by_fixture=cpu_snr,
            packets_equal_to_cpu_port=equal / (12 * S),
            packet_bytes=len(frames[0][0]))
    say("encode_celt", streams=S, frames=12, bitrate=ENCODE_BITRATE,
        margin_db=ENCODE_SNR_MARGIN_DB, **result)


class _FirstArgmin:
    """Inside the block, keeps the input and the result of the first
    torch.argmin call: in nsq_del_dec_frame that is the choice of the
    first sample's winner among the trellis states."""

    def __enter__(self):
        self.seen = None
        self._orig = torch.argmin

        def spy(x, *args, **kwargs):
            out = self._orig(x, *args, **kwargs)
            if self.seen is None:
                self.seen = (x.clone(), out.clone())
            return out

        torch.argmin = spy
        return self

    def __exit__(self, *exc):
        torch.argmin = self._orig


def phase_silk_nsq(dev):
    S = S_MAIN
    KW = nsq_cases.KW
    out = {}
    batches = {}
    silk_nsq.reset_launches()
    for del_dec in (False, True):
        calls = nsq_cases.harvest(del_dec)
        n = len(calls)
        check(n >= 8, f"{n} quantizer calls harvested")
        fn = (partial(silk_nsq.nsq_del_dec_frame, warping=nsq_cases.WARPING)
              if del_dec else silk_nsq.nsq_frame)
        batches[del_dec] = (fn, nsq_cases.batch(calls, S, dev, del_dec))
        got_all = fn(*batches[del_dec][1], **KW)
        got = got_all[0].cpu()
        want = fn(*nsq_cases.batch(calls, n, "cpu", del_dec), **KW)
        check(got.shape == (S, 320) and got.dtype == torch.int32,
              f"pulses {tuple(got.shape)} {got.dtype}")
        lane = torch.arange(S) % n
        # the CPU port's outputs, lane s holding call s % n
        agree = nsq_cases.agreement(got_all, (
            want[0][lane], want[1][lane],
            type(want[2])(*(t[lane] for t in want[2]))))
        why = nsq_cases.held(agree, del_dec)
        check(why is None, f"{'del-dec' if del_dec else 'nsq_frame'} "
              f"against the CPU port: {why}")
        share = agree["share"]
        same = int((got == got[lane]).all(1).sum())
        check(same == S, f"{S - same} lanes differ from the first lane that "
              "holds the same call")
        res = dict(calls=n, min_share=float(share.min()),
                   mean_share=float(share.mean()),
                   lanes_exactly_equal=agree["exact"],
                   state_err_on_exact_lanes=agree["state_err"],
                   lanes_equal_to_their_first_copy=same)
        if del_dec:
            # the first sample: where every state has the same cost, the
            # first state wins in the plain version on the card (its
            # torch.argmin watched), and the kernel gives the plain
            # version's pulses and seed on those lanes
            with _FirstArgmin() as first:
                plain = silk_nsq.nsq_del_dec_frame_reference(
                    *batches[del_dec][1], **KW, warping=nsq_cases.WARPING)
            cost, win = first.seen
            check(cost.is_cuda and cost.shape == (S, silk_nsq.MAX_DD_STATES),
                  f"first-sample costs {tuple(cost.shape)} on {cost.device}")
            tied = (cost == cost[:, :1]).all(1)
            check(int(tied.sum()) > 0, "no lane ties at the first sample")
            check(bool((win[tied] == 0).all()),
                  f"first-sample winners of tied lanes: "
                  f"{sorted(set(win[tied].tolist()))}")
            check(torch.equal(got_all[0][tied], plain[0][tied])
                  and torch.equal(got_all[1][tied], plain[1][tied]),
                  "the kernel's pulses or seeds differ from the plain "
                  "version's on the lanes tied at the first sample")
            res.update(first_sample_tied_lanes=int(tied.sum()),
                       first_sample_winners_of_tied_lanes=sorted(
                           set(win[tied].tolist())))
        out["del_dec" if del_dec else "single"] = res
    counts = _kernel_counts()
    for name in NSQ_KERNELS:
        check(counts[name] == 1, f"{name}: {counts[name]} launches in one "
              "call")
        NSQ_LAUNCHES[name][("silk_nsq", S)] = counts[name]
    say("silk_nsq", streams=S, kernel_launches={k: counts[k]
                                                for k in NSQ_KERNELS},
        **out)
    return batches


def phase_encode_silk(dev, mono):
    S, F = 8, 4
    batched = SilkEncodePipeline(S, bitrate=24000, device=dev)
    solo = SilkEncodePipeline(1, bitrate=24000, device=dev)
    dec = OpusStreamPipeline(S, channels=1, device=dev)
    silk_nsq.reset_launches()
    t0 = time.perf_counter()
    sizes = []
    for f in range(F):
        pcm = _pcm_batch(mono, S, f)[:, :, 0]
        pkts = batched.step(pcm)
        check(len(pkts) == S and all(p and len(p) > 2 for p in pkts),
              f"SILK encode frame {f}: an empty packet")
        check(solo.step(pcm[:1])[0] == pkts[0],
              f"SILK encode frame {f}: stream 0 differs from itself alone")
        out = dec.step(pkts).cpu().numpy()
        check(out.shape == (S, FRAME, 1) and bool(np.isfinite(out).all()),
              f"SILK packets of frame {f} decode to {out.shape}")
        check(set(int(m) for m in dec.last_modes) == {1},
              f"decoded modes {dec.last_modes}: SILK expected")
        sizes.append([len(p) for p in pkts])
    seconds = round(time.perf_counter() - t0, 2)
    _nsq_launches_held("encode_silk", {S: batched._ex.dispatches,
                                       1: solo._ex.dispatches})
    say("encode_silk", streams=S, frames=F, bitrate=24000,
        device_quantizer_calls=batched._ex.dispatches,
        solo_quantizer_calls=solo._ex.dispatches,
        kernel_launches=silk_nsq.nsq_del_dec_launches,
        packet_bytes_last_frame=sizes[-1], seconds=seconds)


def _nsq_launches_held(path: str, dispatches: dict) -> None:
    """A path's executors quantized through the delayed-decision kernel:
    one launch for each device quantizer call (`dispatches`: the
    executors' width -> their calls), and none of the single state's
    (counts reset just before the path)."""
    total = sum(dispatches.values())
    check(total > 0, f"{path}: no device quantizer call")
    check(silk_nsq.nsq_del_dec_launches == total
          and silk_nsq.nsq_frame_launches == 0,
          f"{path}: {silk_nsq.nsq_del_dec_launches} delayed-decision and "
          f"{silk_nsq.nsq_frame_launches} single-state launches for "
          f"{total} device quantizer calls")
    for S, n in dispatches.items():
        NSQ_LAUNCHES["nsq_del_dec"][(path, S)] = n


@contextlib.contextmanager
def _counted_dispatches():
    """The NsqBatchExecutor device calls made inside, by the executor's
    width, in a dict."""
    from mousiki_tpu_torch.parallel.nsq_batch import NsqBatchExecutor
    n: dict = {}
    dispatch = NsqBatchExecutor._dispatch

    def counted(self, reqs):
        n[self.S] = n.get(self.S, 0) + 1
        return dispatch(self, reqs)

    NsqBatchExecutor._dispatch = counted
    try:
        yield n
    finally:
        NsqBatchExecutor._dispatch = dispatch


def phase_encode_quality(dev, card):
    """The encoders' quality chain on the card against the fixture made by
    the CPU port and libopus (mousiki_tpu_torch/quality.py). Returns the
    kernel's launches in the CELT decode."""
    fx = quality.load_fixture()
    t0 = time.perf_counter()
    celt = [quality.encode_celt_corpus(rate, device=dev)
            for rate in quality.CELT_RATES]
    t_encode = time.perf_counter() - t0
    corpus = quality.load_corpus()
    ref16 = quality.downmix_16k(corpus[: len(corpus) // FRAME * FRAME])
    t0 = time.perf_counter()
    _reset_launches()
    scores = quality.score(ref16, celt, 2,
                           partial(quality.decode_celt_port, device=dev))
    launches = deemph.deemphasis_launches
    leaf = _kernel_counts()
    t_decode = time.perf_counter() - t0
    celt_rows = []
    for k, rate in enumerate(quality.CELT_RATES):
        got, want = scores[k], fx["celt_scores"][k]
        for key in ("err4", "err16"):
            check(abs(got[key] - want[key]) <= QUALITY_TOL,
                  f"encode quality {rate} bit/s: {key} {got[key]:.4f} on "
                  f"the card against {want[key]:.4f} (bar {QUALITY_TOL})")
        celt_rows.append(dict(rate=rate, card=got, fixture=want,
                              equal_to_fixture=quality.equal_share(
                                  celt[k], fx["celt_packets"][k])))
    n = quality.FIXTURE_SILK_FRAMES
    silk_nsq.reset_launches()
    t0 = time.perf_counter()
    with _counted_dispatches() as dispatches:
        packets, calls = quality.encode_silk_cases(quality.SILK_WIDEBAND,
                                                   device=dev, n_frames=n)
    t_silk = time.perf_counter() - t0
    _nsq_launches_held("encode_quality", dispatches)
    check(all(c > 0 for c in calls),
          f"device quantizer calls by lane {calls}: every lane expected")
    x = quality.speech_frames()[: n * FRAME, None]
    silk_rows = []
    for k, pcm in enumerate(quality.decode_opus_port(packets, 1,
                                                     device=dev)):
        check(pcm.shape == x.shape and bool(np.isfinite(pcm).all()),
              f"SILK lane {k} decodes to {pcm.shape}")
        snr = quality.snr_db(x, pcm)
        want = quality.snr_db(x, fx["silk_libopus_pcm"][k])
        rate = quality.SILK_WIDEBAND[k][0]
        check(snr >= want - ENCODE_SNR_MARGIN_DB,
              f"encode quality SILK {rate} bit/s: {snr:.2f} dB on the card "
              f"under {want:.2f} - {ENCODE_SNR_MARGIN_DB}")
        silk_rows.append(dict(rate=rate, device_calls=calls[k], snr_db=snr,
                              fixture_snr_db=want,
                              equal_to_fixture=quality.equal_share(
                                  packets[k], fx["silk_packets"][k])))
    frames = len(celt[0])
    say("encode_quality", card=card, celt=celt_rows, celt_tol=QUALITY_TOL,
        silk=silk_rows, silk_frames=n, silk_margin_db=ENCODE_SNR_MARGIN_DB,
        deemphasis_launches=launches, kernel_launches=leaf,
        celt_frames=frames,
        celt_encode_seconds=round(t_encode, 1),
        celt_decode_score_seconds=round(t_decode, 1),
        silk_encode_seconds=round(t_silk, 1),
        silk_device_quantizer_calls=sum(dispatches.values()))
    check(launches == frames, f"encode quality decode: {launches} "
          f"deemphasis launches in {frames} frames: one a frame expected")
    _path_launches("encode_quality", frames, got=leaf)
    return launches


def phase_encode_timing(dev, streams, nsq_batches):
    """ms/step of the CELT encoder at S = 256 through step() and through
    encode_stream(K = 8), and the profiles of the encode side."""
    S, K, warm, timed = S_MAIN, 8, 8, 24
    frames = [_pcm_batch(streams, S, f) for f in range(12)]
    chunks = [np.stack([frames[(c + k) % 12] for k in range(K)])
              for c in range(0, warm + timed, K)]

    def run_step(pipe):
        for f in range(warm):
            pipe.step(frames[f % 12])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(warm, warm + timed):
            check(len(pipe.step(frames[f % 12])) == S, "packets missing")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / timed

    def run_stream(pipe):
        for _ in pipe.encode_stream(iter(chunks[:warm // K])):
            pass
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in pipe.encode_stream(iter(chunks[warm // K:])))
        torch.cuda.synchronize()
        check(n == timed, f"{n} frames of {timed} came out")
        return (time.perf_counter() - t0) * 1e3 / n

    modes = {"encode_step": run_step, "encode_stream8": run_stream}
    pipes = {name: CeltEncodePipeline(S, channels=2, bitrate=ENCODE_BITRATE,
                                      device=dev) for name in modes}
    runs: dict = {name: [] for name in modes}
    for _ in range(TIMING_REPEATS):
        for name, fn in modes.items():
            runs[name].append(fn(pipes[name]))
    for name, ms in runs.items():
        median = float(np.median(ms))
        say(f"timing_{name}_S{S}", streams=S, ms_per_step=median,
            ms_per_step_min=min(ms), ms_per_step_runs=ms,
            realtime_x=S * 0.02 / (median / 1e3))
    pipe = pipes["encode_step"]
    _profile(f"encode_step_S{S}", lambda f: pipe.step(frames[f]))
    # one executor dispatch of each quantizer at S = 256 (the harvested
    # calls tiled), profiled after one unprofiled: its spans' host time
    # and launches, one kernel launch a dispatch
    for del_dec, (fn, args) in nsq_batches.items():
        kernel = "nsq_del_dec" if del_dec else "nsq_frame"
        name = f"nsq_{'del_dec' if del_dec else 'frame'}_S{S}"
        wall_ms = _wall_ms(lambda: fn(*args, **nsq_cases.KW))
        ex, reqs = nsq_cases.executor_requests(
            nsq_cases.harvest(del_dec), S, del_dec, dev)
        dispatch_ms = _wall_ms(lambda: ex._dispatch(reqs))
        prof = _profile_step(lambda: ex._dispatch(reqs), name)
        check(prof["kernel_launches"][kernel] == 1 and ex.dispatches == 2,
              f"{name}: {prof['kernel_launches'][kernel]} kernel launches "
              "in one dispatch")
        quantize = prof["launches_by_span"].get("nsq.quantize", 0)
        check(quantize <= NSQ_MAX_QUANTIZE_LAUNCHES,
              f"{name}: {quantize} launches in nsq.quantize, at most "
              f"{NSQ_MAX_QUANTIZE_LAUNCHES} expected")
        say(f"profile_{name}", unprofiled_wall_ms=wall_ms,
            unprofiled_dispatch_ms=dispatch_ms, **prof)


# ------------------------------------------------------- neural recovery

S_NEURAL = 64                 # bench.py bench_deep_recovery's S
NEURAL_PCM_TOL = 1e-4         # tests/test_deep_recovery.py:92
PERIOD_TOL = 1e-3             # a flip is excused within this of an integer


def _bench_features(S):
    """bench.py bench_deep_recovery's features: (S, 2, 20) * 0.3."""
    return (np.random.default_rng(0).standard_normal((S, 2, 20))
            .astype(np.float32) * 0.3)


def phase_neural_conceal(dev):
    S, calls = S_NEURAL, 5
    feats = _bench_features(S)
    gpu = BatchedDeepRecovery(S, device=dev)
    cpu = BatchedDeepRecovery(S, device="cpu")
    flips, flipped, worst_period = [], np.zeros(S, bool), 0.0
    got, want = [], []
    _reset_launches()
    for k in range(calls):
        got.append(gpu.conceal(feats).cpu().numpy())
        want.append(cpu.conceal(feats).numpy())
        pg = gpu.last_periods.cpu().numpy()
        pc = cpu.last_periods.numpy()
        worst_period = max(worst_period, float(np.abs(pg - pc).max()))
        for s, f in zip(*np.nonzero(pg.astype(np.int32)
                                    != pc.astype(np.int32))):
            dist = float(abs(pc[s, f] - np.round(pc[s, f])))
            flips.append(dict(call=k, lane=int(s), frame=int(f),
                              card=float(pg[s, f]), cpu=float(pc[s, f]),
                              cpu_distance_from_integer=dist))
            print(f"[neural_conceal] period flip {flips[-1]}", flush=True)
            check(dist < PERIOD_TOL, f"period flip far from an integer: "
                  f"{flips[-1]}")
            flipped[s] = True
    check(worst_period <= PERIOD_TOL,
          f"PitchDNN periods {worst_period} from the CPU's")
    got, want = np.concatenate(got, 1), np.concatenate(want, 1)
    check(got.shape == (S, calls * 320), f"conceal output {got.shape}")
    check(bool(np.isfinite(got).all()), "non-finite concealment PCM")
    err = np.abs(got - want).max(axis=1)
    check(bool((err[~flipped] <= NEURAL_PCM_TOL).all()),
          f"concealment PCM {err[~flipped].max()} from the CPU's in a lane "
          "without a period flip")
    launches = _neural_launched("neural_conceal",
                                {"fargan_conceal": calls},
                                {"fargan_conceal": f"conceal_S{S}"})
    say("neural_conceal", streams=S, calls=calls, frames_a_call=2,
        kernel_launches=launches,
        period_flips=len(flips), lanes_with_flips=int(flipped.sum()),
        worst_period_diff=worst_period,
        worst_pcm_err_no_flip=float(err[~flipped].max()),
        bar=NEURAL_PCM_TOL, max_abs_pcm=float(np.abs(got).max()))


def _seeded_dreds(S):
    """S OpusDred from dred_encode of seeded latents (26 a stream) at
    several quantizer levels, parsed back: the budget cuts some short."""
    stats = dred.synthetic_stats()
    rng = np.random.default_rng(11)
    out = []
    for s in range(S):
        lat = [(rng.standard_normal(24) * 1.5).astype(np.float32)
               for _ in range(26)]
        st = rng.standard_normal(24).astype(np.float32)
        payload = dred.dred_encode(lat, st, stats, q0=3 + s % 10,
                                   dq=s % 8, offset=0, max_bytes=160)
        out.append(dred.OpusDred(dred.dred_parse(payload, stats), payload))
    return out


def phase_rdovae_decode(dev):
    S = S_NEURAL
    dreds = _seeded_dreds(S)
    gpu = BatchedDeepRecovery(S, device=dev)
    _reset_launches()
    feats, n10 = gpu.process(dreds)
    launches = _neural_launched("rdovae_process", {"rdovae_decode": 1},
                                {"rdovae_decode": "rdovae_S64"})
    want, want_n = BatchedDeepRecovery(S, device="cpu").process(dreds)
    check(bool((n10 == want_n).all()), "valid frame counts differ")
    check(bool(np.isfinite(feats).all()), "non-finite features")
    scale = float(np.abs(want).max())
    err = float(np.abs(feats - want).max())
    check(err <= 1e-4 * scale, f"features {err} from the CPU port's "
          f"(bar 1e-4 * {scale})")
    rows = {}
    _reset_launches()
    for s in (0, S - 1):
        one = np.stack(dred.opus_dred_process(dreds[s],
                                              model=gpu.dec_model))
        d = float(np.abs(feats[s, feats.shape[1] - n10[s]:] - one).max())
        check(d <= 1e-4 * scale, f"row {s}: {d} from opus_dred_process")
        rows[f"row{s}_vs_opus_dred_process"] = d
    one_launches = _neural_launched("opus_dred_process", {"rdovae_decode": 2},
                                    {"rdovae_decode": "rdovae_S1"})
    say("rdovae_decode", streams=S, qframes=int(n10.max()) // 4,
        kernel_launches=launches, opus_dred_process_launches=one_launches,
        qframes_min=int(n10.min()) // 4, worst_abs_err_vs_cpu=err,
        bar=1e-4 * scale, **rows)
    return dreds


def _speechish(n, seed):
    """The signal of the DRED tests (tests/test_deep_recovery.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * t)
    sig = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 48000)
    sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig += 0.01 * rng.standard_normal(n)
    return sig.astype(np.float32)[:, None]


def _dred_encoder(model=None):
    enc = OpusEncoder(48000, 1)
    enc.set_bitrate(24000)
    enc.set_dred_duration(40, model=model)
    return enc


def phase_dred_encode(dev):
    S, F = 2, 10
    t0 = time.perf_counter()
    cpu_model = rdovae.random_enc(torch.Generator().manual_seed(0),
                                  device="cpu")
    packets, equal, with_dred = [], 0, []
    for s in range(S):
        card, host = _dred_encoder(), _dred_encoder(cpu_model)
        check(card._dred.device.type == "cuda",
              f"the DRED encoder runs on {card._dred.device}")
        sig = _speechish(FRAME * F, seed=10 + s)
        pk = []
        for f in range(F):
            pcm = sig[f * FRAME:(f + 1) * FRAME]
            pk.append(card.encode(pcm, FRAME))
            equal += pk[-1] == host.encode(pcm, FRAME)
        packets.append(pk)
        with_dred.append(sum(dred.opus_dred_parse(p) is not None
                             for p in pk))
    check(min(with_dred) >= 8, f"DRED parses from {with_dred} packets")
    dec = OpusStreamPipeline(S, channels=1, device=dev)
    for f in range(F):
        out = dec.step([opus_packet_unpad(packets[s][f]) for s in range(S)])
        check(out.shape == (S, FRAME, 1) and bool(torch.isfinite(out).all()),
              f"DRED packets of frame {f} decode to {tuple(out.shape)}")
    say("dred_encode", streams=S, frames=F, packets_with_dred=with_dred,
        packets_equal_to_cpu_port=equal / (S * F),
        seconds=round(time.perf_counter() - t0, 2))


def phase_neural_timing(dev, dreds):
    """bench.py's dred_recovery_x_s64 (3 windows, not 6) at S = 64 and
    S = 256, process() timed at S = 64, and the profiles of a conceal
    call at each width and of one process call."""
    n_steps, windows = 10, 3
    recs = {}
    for S in (S_NEURAL, 256):
        rec = recs[S] = BatchedDeepRecovery(S, device=dev)
        feats = _bench_features(S)
        _reset_launches()
        rec.conceal(feats)
        torch.cuda.synchronize()
        rates = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(n_steps):
                rec.conceal(feats)
            torch.cuda.synchronize()
            rates.append(S * n_steps * 0.02 / (time.perf_counter() - t0))
        launches = _neural_launched(
            f"dred_recovery_x_s{S}", {"fargan_conceal": 1 + windows * n_steps},
            {"fargan_conceal": f"conceal_S{S}"})
        say(f"timing_dred_recovery_x_s{S}", streams=S,
            realtime_x=float(np.median(rates)),
            realtime_x_windows=rates,
            ms_per_call=S * 0.02 / float(np.median(rates)) * 1e3,
            kernel_launches=launches)
    rec = recs[S_NEURAL]
    runs = []
    _reset_launches()
    for _ in range(windows):
        t0 = time.perf_counter()
        rec.process(dreds)          # ends in its read-back
        runs.append((time.perf_counter() - t0) * 1e3)
    launches = _neural_launched("process_timing_s64",
                                {"rdovae_decode": windows},
                                {"rdovae_decode": "rdovae_S64"})
    say("timing_process_S64", streams=S_NEURAL, ms_per_call=float(
        np.median(runs)), ms_per_call_runs=runs, kernel_launches=launches)

    def profiled(name, call, kernel):
        """One profiled call: one launch of its kernel, and at S = 64 at
        most NEURAL_MAX_LAUNCHES launches in all."""
        before = _neural_counts()[kernel]
        prof = _profile_step(call, name)
        n = _neural_counts()[kernel] - before
        check(n == 1, f"profiled {name}: {n} launches of {kernel}")
        if name.endswith("S64"):
            check(prof["launches"] <= NEURAL_MAX_LAUNCHES,
                  f"profiled {name}: {prof['launches']} launches, at most "
                  f"{NEURAL_MAX_LAUNCHES} expected")
        say(f"profile_{name}", **prof, neural_kernel_launches=n)

    for S, r in recs.items():
        feats = _bench_features(S)
        _profile_step(lambda: r.conceal(feats))
        profiled(f"conceal_S{S}", lambda: r.conceal(feats),
                 "fargan_conceal")
    rec.process(dreds)
    profiled("process_S64", lambda: rec.process(dreds), "rdovae_decode")


# ------------------------------------------------- the single-stream API


def phase_python_host(dev, streams):
    """The Python host decoder in front of the device synthesis."""
    S, F = S_PYHOST, 12
    pipe = CeltStreamPipeline(S, 2, use_native=False, device=dev)
    check(pipe._native is None and len(pipe._py_hosts) == S,
          "use_native=False did not take the Python host")
    _reset_launches()
    worst, launches, step_ms = 0.0, [], []
    for f in range(F):
        t0 = time.perf_counter()
        pcm = pipe.step(frame_batch(streams, S, f), FRAME)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(deemph.deemphasis_launches)
        got = pcm.cpu().numpy()
        check(got.shape == (S, FRAME, 2), f"pcm shape {got.shape}")
        check(bool(np.isfinite(got).all()), f"non-finite pcm at frame {f}")
        err = np.abs(got - golden_pcm(streams, S, f)).max(axis=(1, 2))
        check(bool((err <= GOLDEN_TOL).all()),
              f"Python host frame {f}: {int((err > GOLDEN_TOL).sum())} "
              f"streams beyond {GOLDEN_TOL}, worst {err.max()}")
        worst = max(worst, float(err.max()))
    n = deemph.deemphasis_launches
    check(all(b - a == 1 for a, b in zip([0] + launches, launches)),
          f"deemphasis launches per Python-host step {launches}")
    steps = _path_launches("celt_python_host", F, executor=False)
    median = float(np.median(step_ms[2:]))
    say("python_host", streams=S, frames=F, worst_abs_err_vs_golden=worst,
        bar=GOLDEN_TOL, deemphasis_launches=n, kernel_launches=steps,
        launches_after_each_step=launches, ms_per_step=median,
        ms_per_step_runs=step_ms, ms_per_stream_frame=median / S,
        realtime_x=S * 0.02 / (median / 1e3))
    return n


def phase_single_stream():
    """The single-stream API of hostcodec/ through the package's top-level
    names, on the golden streams."""
    import mousiki_tpu_torch as api
    from golden_streams import load_all
    t0 = time.perf_counter()
    streams = load_all()
    worst, packets = 0.0, 0
    for st in streams:
        channels = st.pcm.shape[1]
        dec = api.OpusDecoder(48000, channels)
        for f, pkt in enumerate(st.packets):
            pcm = dec.decode(pkt, FRAME)
            check(dec.final_range == st.ranges[f],
                  f"{st.name} packet {f}: final range {dec.final_range}, "
                  f"fixture {st.ranges[f]}")
            err = float(np.abs(pcm - st.pcm[f * FRAME:(f + 1) * FRAME])
                        .max())
            check(err <= GOLDEN_TOL, f"{st.name} packet {f}: {err}")
            worst = max(worst, err)
            packets += 1
    check(packets == 96, f"{packets} golden packets decoded")
    st = streams[0]
    typed = api.Decoder(48000, api.Channels(st.pcm.shape[1]))
    plain = api.OpusDecoder(48000, st.pcm.shape[1])
    for pkt in st.packets:
        check(np.array_equal(typed.decode_float(pkt, FRAME),
                             plain.decode(pkt, FRAME)),
              "codec.Decoder differs from OpusDecoder")
    enc = api.MultistreamEncoder.surround(48000, 6)
    enc.set_bitrate(256000)
    msdec = api.MultistreamDecoder(48000, 6, enc.streams, enc.coupled,
                                   enc.mapping)
    t = np.arange(FRAME * 3) / 48000.0
    sig = np.stack([(0.4 / (1 + c)) * np.sin(2 * np.pi * (200 + 130 * c) * t)
                    for c in range(6)], 1)
    sig += 0.01 * np.random.default_rng(6).standard_normal(sig.shape)
    for f in range(3):
        out = msdec.decode(enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME),
                           FRAME)
        check(out.shape == (FRAME, 6) and bool(np.isfinite(out).all()),
              f"5.1 round trip frame {f}: {out.shape}")
    surround_peak = float(np.abs(out).max())
    check(surround_peak > 1e-3, "5.1 round trip is silent")
    writer = api.OggOpusWriter(st.pcm.shape[1], preskip=312)
    for pkt in st.packets:
        writer.write_packet(pkt, FRAME)
    blob = writer.finish()
    read = [p for p, _ in api.OggOpusReader(blob).packets()]
    check(read == st.packets, "Ogg round trip changed the packets")
    ogg_file = api.OpusFile(blob)
    ogg_pcm = ogg_file.decode_all()
    ogg_err = float(np.abs(ogg_pcm - st.pcm[312:]).max())
    check(ogg_file.pcm_total() == 12 * FRAME and ogg_err <= GOLDEN_TOL,
          f"OpusFile: {ogg_file.pcm_total()} samples, {ogg_err} from golden")
    say("single_stream", streams=len(streams), packets=packets,
        ranges_equal=True, worst_abs_err_vs_golden=worst, bar=GOLDEN_TOL,
        surround_peak=surround_peak, ogg_bytes=len(blob),
        ogg_worst_abs_err_vs_golden=ogg_err,
        seconds=round(time.perf_counter() - t0, 2))


def _deep_decoder(device):
    """OpusDecoder(48000, 1) with the port's seeded FARGAN (seed 2),
    PitchDNN (seed 3) and RDOVAE decoder (seed 1) on `device`."""
    from mousiki_tpu_torch import OpusDecoder
    dec = OpusDecoder(48000, 1)
    dec.set_deep_plc(
        fargan.random_model(torch.Generator().manual_seed(2), device=device),
        deep_plc.random_pitchdnn(torch.Generator().manual_seed(3),
                                 device=device))
    dec.set_dred_models(rdovae.random_dec(torch.Generator().manual_seed(1),
                                          device=device),
                        dred.synthetic_stats())
    return dec


def phase_deep_plc(dev):
    """Deep PLC and the DRED decode of the single-stream OpusDecoder on
    the card against the same decoder on the CPU."""
    t0 = time.perf_counter()
    enc = _dred_encoder(rdovae.random_enc(torch.Generator().manual_seed(0),
                                          device="cpu"))
    sig = _speechish(FRAME * 11, seed=21)
    pkts = [enc.encode(sig[f * FRAME:(f + 1) * FRAME], FRAME)
            for f in range(11)]
    encode_s = round(time.perf_counter() - t0, 2)
    card, host = _deep_decoder(dev), _deep_decoder("cpu")
    check(card.deep_plc.device.type == "cuda",
          f"deep PLC runs on {card.deep_plc.device}")
    _reset_launches()
    flips, worst, conceal_ms = [], {"good": 0.0, "dred": 0.0,
                                    "plc": 0.0}, []
    flipped = False

    def compare(kind, got, want):
        nonlocal flipped
        check(got.shape == want.shape and bool(np.isfinite(got).all()),
              f"{kind}: {got.shape} / {want.shape}")
        if kind != "good":
            pc = float(host.deep_plc.last_period[0])
            pg = float(card.deep_plc.last_period[0])
            if int(pc) != int(pg):
                dist = abs(pc - round(pc))
                flips.append(dict(kind=kind, card=pg, cpu=pc,
                                  cpu_distance_from_integer=dist))
                print(f"[deep_plc] period flip {flips[-1]}", flush=True)
                check(dist < PERIOD_TOL,
                      f"period flip far from an integer: {flips[-1]}")
                flipped = True
        err = float(np.abs(got - want).max())
        if not flipped:
            check(err <= NEURAL_PCM_TOL, f"{kind} PCM {err} from the CPU's")
            worst[kind] = max(worst[kind], err)

    def on_card(fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        conceal_ms.append((time.perf_counter() - t) * 1e3)
        return out

    for pkt in pkts[:8]:
        compare("good", card.decode(pkt, FRAME), host.decode(pkt, FRAME))
    parsed = [d.dred_parse(pkts[10]) for d in (card, host)]
    check(all(p is not None for p in parsed), "no DRED in packet 10")
    feats = [np.stack(d.dred_process(p)) for d, p in zip((card, host),
                                                         parsed)]
    scale = max(1.0, float(np.abs(feats[1]).max()))
    feat_err = float(np.abs(feats[0] - feats[1]).max())
    check(feat_err <= 1e-4 * scale,
          f"DRED features {feat_err} from the CPU's (bar 1e-4 * {scale})")
    for k in (2, 1):            # the gap, oldest first (10 ms units)
        compare("dred",
                on_card(card.dred_decode, parsed[0], 2 * k, FRAME),
                host.dred_decode(parsed[1], 2 * k, FRAME))
    compare("good", card.decode(pkts[10], FRAME), host.decode(pkts[10], FRAME))
    for d in (card, host):      # what is left of the DRED features goes
        d.inject_dred_features([])
    compare("plc", on_card(card.decode, None, FRAME),
            host.decode(None, FRAME))
    prof = _profile_step(lambda: card.decode(None, FRAME), "deep_plc_decode")
    # one DRED decode, and one conceal launch a concealed frame: the two
    # DRED frames, the plain loss and the profiled one
    launches = _neural_launched(
        "deep_plc", {"rdovae_decode": 1, "fargan_conceal": 4},
        {"rdovae_decode": "rdovae_S1", "fargan_conceal": "deep_plc_S1"})
    say("deep_plc", packets=len(pkts), encode_seconds=encode_s,
        kernel_launches=launches,
        dred_latents=parsed[0].nb_latents, feature_err=feat_err,
        feature_bar=1e-4 * scale, period_flips=len(flips),
        worst_pcm_err_good=worst["good"], worst_pcm_err_dred=worst["dred"],
        worst_pcm_err_plc=worst["plc"], bar=NEURAL_PCM_TOL,
        card_ms_per_lost_frame=conceal_ms,
        decode_none_launches=prof["launches"],
        decode_none_profiled_wall_ms=prof["profiled_wall_ms"],
        decode_none_device_busy_ms=prof["device_busy_ms"],
        seconds=round(time.perf_counter() - t0, 2))


# -------------------------------------------------- the lockstep decoder

# the stages of lockstep_synthesis_step, by the name it calls them under
LOCKSTEP_STAGES = ("decode_symbols", "walk_bands", "finish_frames",
                   "execute_packed", "synthesis_step")


class _StageTimer:
    """Host wall time of each stage of the lockstep step: wraps the
    stage functions in the module namespace that calls them, with a
    synchronize on both sides (the host is the bound here, so the wait
    costs next to nothing)."""

    def __init__(self):
        self.ms = {}
        self.saved = {}

    def __enter__(self):
        for name in LOCKSTEP_STAGES:
            fn = self.saved[name] = getattr(lockstep, name)

            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.ms[_name] = round(self.ms.get(_name, 0.0) + (
                    time.perf_counter() - t) * 1e3, 3)
                return out

            setattr(lockstep, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(lockstep, name, fn)


def _device_trace(step):
    """One call of `step` under a device-only torch.profiler trace (a
    step is about a million launches: a CPU trace of it would be several
    million events). Returns the kernels it ran, their summed time, the
    other device activities (copies, sets) and the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    kernels, other, busy_ns = 0, 0, 0
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        if ev.name().startswith(("Memcpy", "Memset")):
            other += 1
        else:
            kernels += 1
        busy_ns += ev.duration_ns()
    check(kernels > 0, "the device trace saw no kernel")
    wall_ms = (t1 - t0) * 1e3
    return {"device_kernels": kernels, "device_copies_and_sets": other,
            "device_busy_ms": round(busy_ns / 1e6, 3),
            "profiled_wall_ms": round(wall_ms, 3),
            "device_busy_share": round(busy_ns / 1e6 / wall_ms, 4),
            "trace_stop_s": round(t2 - t1, 2),
            "trace_read_s": round(time.perf_counter() - t2, 2)}


def phase_lockstep(dev, streams, mono):
    """The lockstep decoder on the card at S = 256, stereo and mono."""
    t_phase = time.perf_counter()
    launches = {}
    for name, C, src in (("celt_lockstep", 2, streams),
                         ("celt_lockstep_mono", 1, [mono[0]])):
        S, F = S_MAIN, LOCKSTEP_FRAMES
        t_width = time.perf_counter()
        consts = synthesis.make_consts(FRAME, dev)
        mats = plan_combo_mats(C, FRAME, dev)
        state = [synthesis.init_state(S, C, dev),
                 lockstep.init_state(S, device=dev)]

        def step(f):
            buf, lens = lockstep.pad_payloads(frame_batch(src, S, f), dev)
            pcm, state[0], state[1], ok = lockstep.lockstep_synthesis_step(
                consts, state[0], state[1], buf, lens, mats, C=C,
                frame=FRAME)
            return pcm, ok

        _reset_launches()
        worst, step_ms, after, leaf_after = 0.0, [], [], []
        prof = None
        for f in range(F):
            out = []
            if f == F - 1:
                prof = _device_trace(lambda: out.append(step(f)))
                step_ms.append(prof["profiled_wall_ms"])
            else:
                with _StageTimer() as stages, _emission_walks() as walks, \
                        _step_calls() as (staged, assembled, combed):
                    t = time.perf_counter()
                    out.append(step(f))
                    torch.cuda.synchronize()
                    step_ms.append(round((time.perf_counter() - t) * 1e3, 3))
            after.append(deemph.deemphasis_launches)
            leaf_after.append(_kernel_counts())
            pcm, ok = out[0]
            n_ok = int(ok.sum())
            check(n_ok == S, f"{name} frame {f}: {S - n_ok} lanes not ok")
            got = pcm.cpu().numpy()
            check(got.shape == (S, FRAME, C), f"{name} pcm {got.shape}")
            check(bool(np.isfinite(got).all()), f"{name} non-finite pcm")
            err = np.abs(got - golden_pcm(src, S, f)).max(axis=(1, 2))
            check(bool((err <= GOLDEN_TOL).all()),
                  f"{name} frame {f}: {int((err > GOLDEN_TOL).sum())} lanes "
                  f"beyond {GOLDEN_TOL}, worst {err.max()}")
            worst = max(worst, float(err.max()))
        n = deemph.deemphasis_launches
        check(after == list(range(1, F + 1)),
              f"{name}: deemphasis launches after each step {after}")
        # the walk runs in the plan emission
        leaf = _path_launches(name, F, after_each=leaf_after, lockstep=True)
        _emission_walk_times(name, walks)
        _own_step_rows(name, staged, assembled, combed)
        launches[name] = n
        say(f"lockstep_{name}", streams=S, channels=C, frames=F,
            worst_abs_err_vs_golden=worst, bar=GOLDEN_TOL,
            deemphasis_launches=n, kernel_launches=leaf,
            ms_per_step=step_ms[0],
            realtime_x=S * 0.02 / (step_ms[0] / 1e3),
            stage_ms_first_step=stages.ms,
            launches_per_step=prof["device_kernels"],
            seconds=round(time.perf_counter() - t_width, 1), **{
                f"profiled_{k}": v for k, v in prof.items()})
    say("lockstep", seconds=round(time.perf_counter() - t_phase, 1))
    return launches


def mesh_layout(dev):
    """The stream mesh: every card when there are two or more, else two
    shards on the one card. Returns (mesh, streams, shards_on_one_card),
    the streams S_MAIN rounded up to a multiple of the mesh size."""
    if torch.cuda.device_count() >= 2:
        mesh, one_card = make_mesh(), False
    else:
        mesh, one_card = StreamMesh([dev, dev]), True
    return mesh, -(-S_MAIN // mesh.size) * mesh.size, one_card


def _mesh_against_single(name, dev, mesh, make_pipe, batch_fn, S, F, lost):
    """F frames through a single-device pipeline and then through the mesh
    (launch counts reset just before the mesh run), every lane within
    BATCH_TOL; returns the mesh's PCM on the host, its kernel launches and
    the worst differences on the streams that have lost nothing yet and
    on the others."""
    single = make_pipe(None)
    with _plc_label(f"{name}_single"):
        want = [single.step(batch_fn(f, lost[:, f])).cpu().numpy()
                for f in range(F)]
    del single
    pipe = make_pipe(mesh)
    _reset_launches()
    got = []
    with _plc_label(name):
        for f in range(F):
            pcm = pipe.step(batch_fn(f, lost[:, f]))
            check(pcm.device == dev, f"{name}: pcm on {pcm.device}, not "
                  f"{dev}")
            got.append(pcm.cpu().numpy())
    torch.cuda.synchronize()
    # one launch a lossy shard a step
    _plc_held(name, [(S // mesh.size, got[0].shape[2])])
    launches = deemph.deemphasis_launches
    worst_clean = worst_touched = 0.0
    for f in range(F):
        check(got[f].shape == want[f].shape, f"{name} pcm {got[f].shape}")
        check(bool(np.isfinite(got[f]).all()), f"{name}: non-finite pcm")
        err = np.abs(got[f] - want[f]).max(axis=(1, 2))
        touched = lost[:, :f + 1].any(axis=1)
        worst_clean = max(worst_clean, float(err[~touched].max()))
        if touched.any():
            worst_touched = max(worst_touched, float(err[touched].max()))
    check(max(worst_clean, worst_touched) <= BATCH_TOL,
          f"{name}: {worst_clean} on the streams that lost nothing, "
          f"{worst_touched} on the others, from the single device")
    check(launches == F * mesh.size,
          f"{name}: {launches} deemphasis launches, {F * mesh.size} "
          "expected (one a shard a step)")
    _path_launches(name.replace("mesh_", "") + "_mesh", F,
                   calls_a_step=mesh.size)
    return got, launches, worst_clean, worst_touched


def phase_mesh(dev, streams, mono, mesh, S, one_card):
    """The stream mesh (parallel/streaming.py): the stereo CELT plan path
    and the mixed mono path split over the mesh, against single-device
    pipelines fed the same frames; then ms/step of both in turns and one
    profiled mesh step."""
    F = 12
    say("mesh", device_count=torch.cuda.device_count(), shards=mesh.size,
        devices=[str(d) for d in mesh.devices], streams=S,
        shards_on_one_card=str(one_card).lower())
    rng = np.random.default_rng(23)
    lost = rng.random((S, F)) < 0.10
    lost[:, :2] = False
    got, n_celt, clean_err, touched_err = _mesh_against_single(
        "mesh_celt", dev, mesh,
        lambda m: CeltStreamPipeline(S, 2, mesh=m, use_plan=True,
                                     device=dev),
        partial(frame_batch, streams, S), S, F, lost)
    # streams that lost nothing against the golden PCM
    clean = ~lost.any(axis=1)
    worst_golden = max(float(np.abs(got[f][clean] - golden_pcm(
        streams, S, f)[clean]).max()) for f in range(F))
    check(worst_golden <= GOLDEN_TOL,
          f"mesh: loss-free streams {worst_golden} from the golden PCM")
    say("mesh_celt", streams=S, frames=F, loss_share=float(lost.mean()),
        worst_err_loss_free=clean_err, worst_err_after_loss=touched_err,
        bar=BATCH_TOL,
        loss_free_streams=int(clean.sum()),
        worst_loss_free_err_vs_golden=worst_golden,
        deemphasis_launches=n_celt)
    F = F_MIXED_MESH
    _, n_mixed, clean_err, touched_err = _mesh_against_single(
        "mesh_mixed", dev, mesh,
        lambda m: OpusStreamPipeline(S, channels=1, mesh=m, device=dev),
        partial(frame_batch, mono, S, packets=True), S, F, lost[:, :F])
    say("mesh_mixed", streams=S, frames=F, worst_err_loss_free=clean_err,
        worst_err_after_loss=touched_err, deemphasis_launches=n_mixed)
    # ms/step, loss-free stereo plan path, the two taking turns
    batch = partial(frame_batch, streams, S)
    pipes = {"mesh": CeltStreamPipeline(S, 2, mesh=mesh, use_plan=True,
                                        device=dev),
             "single": CeltStreamPipeline(S, 2, use_plan=True, device=dev)}
    runs = {name: [] for name in pipes}
    for rep in range(TIMING_REPEATS):
        for name, p in pipes.items():
            runs[name].append(_time_stream(p, batch, warm=2 if rep == 0
                                           else 1, steps=MESH_TIMING_STEPS))
    say("mesh_timing", streams=S, shards=mesh.size, **{
        f"{name}_{key}": value for name, ms in runs.items()
        for key, value in (("ms_per_step", float(np.median(ms))),
                           ("ms_per_step_min", min(ms)),
                           ("ms_per_step_runs", ms))})
    # one profiled step of each: the profiler is warm from the phases
    # before; a mesh step should launch a single step's kernels a shard
    # and the gather's concatenation
    single = _profile_step(lambda: pipes["single"].step(batch(5)))
    prof = _profile_step(lambda: pipes["mesh"].step(batch(5)), "mesh_S256")
    say("profile_mesh_S256",
        predicted_launches=mesh.size * single["launches"] + 1,
        single_device_launches=single["launches"],
        gather_launches=prof["launches_by_span"].get("mesh.gather", 0),
        gather_host_ms=prof["host_ms_by_span"].get("mesh.gather", 0.0),
        **prof)
    return n_celt, n_mixed


def phase_libopus(dev, streams):
    """Whether the host has libopus; where it has, the plan pipeline
    against libopus's float decode of the three stereo golden streams."""
    available = oracle.available()
    say("libopus", available=available, version=oracle.version())
    if not available:
        print("libopus=unavailable", flush=True)
        return
    S = len(streams)
    pipe = CeltStreamPipeline(S, 2, use_plan=True, device=dev)
    refs = [oracle.RefDecoder(48000, 2) for _ in range(S)]
    worst = 0.0
    for f in range(len(streams[0].packets)):
        got = pipe.step(frame_batch(streams, S, f)).cpu().numpy()
        for s in range(S):
            want = refs[s].decode_float(streams[s].packets[f], FRAME)
            worst = max(worst, float(np.abs(got[s] - want).max()))
    check(worst <= GOLDEN_TOL,
          f"plan pipeline {worst} from libopus's float decode")
    say("libopus", streams=S, frames=len(streams[0].packets),
        worst_abs_err_vs_libopus=worst, bar=GOLDEN_TOL)


def _not_finite(line: dict) -> list:
    """The bench line's values that should be finite numbers and are not
    (strings and the per-window lists aside)."""
    return [(key, value) for key, value in list(line.items()) + [
                (f"quality.{k}", v) for k, v in line["quality"].items()]
            if not isinstance(value, (str, dict, list))
            and not (isinstance(value, (int, float))
                     and np.isfinite(value))]


def phase_bench(dev):
    """The bench's quick run, then its paths' kernel launches counted."""
    t0 = time.perf_counter()
    line = bench.run(S_MAIN, dev, quick=True, s_big=S_WIDE)
    seconds = round(time.perf_counter() - t0, 1)
    print(json.dumps(line), flush=True)
    check(line["quality_gate"] == "pass",
          f"bench quality gate failed: {line['quality']}")
    bad = _not_finite(line)
    check(not bad, f"bench values not finite: {bad}")
    check(line["device"] == torch.cuda.get_device_name(0)
          and line["power_limit_w"] is not None,
          f"bench device {line['device']!r}, {line['power_limit_w']} W")
    fx = bench.load_fixture()
    pays = fx["synthetic"]["payloads"]
    launches = {}
    for S, path in ((S_MAIN, "bench_e2e"), (S_WIDE, "bench_e2e_s1024")):
        pipe = CeltStreamPipeline(S, 2, use_plan=True, device=dev)
        bench.e2e_window(pipe, pays, 2)
        _reset_launches()
        bench.e2e_window(pipe, pays, BENCH_WINDOW)
        launches[path] = deemph.deemphasis_launches
        _path_launches(path, BENCH_WINDOW)
        check(launches[path] == BENCH_WINDOW,
              f"{path}: {launches[path]} deemphasis launches in "
              f"{BENCH_WINDOW} steps: one a step expected")
        del pipe
    n_gate = bench.QUICK.gate_frames
    _reset_launches()
    r, _ = bench._gate_one(pays[:n_gate], fx["synthetic"]["ref16k_quick"],
                           dev)
    launches["bench_gate"] = deemph.deemphasis_launches
    _path_launches("bench_gate", n_gate)
    check(launches["bench_gate"] == n_gate,
          f"gate: {launches['bench_gate']} deemphasis launches in "
          f"{n_gate} frames: one a frame expected")
    check(r["ok"], f"gate decode failed opus_compare: {r}")
    RESULTS["bench"] = line
    say("bench_run", seconds=seconds, value=line["value"],
        value_stream_20ms=line["value_stream_20ms"],
        value_s1024=line["value_s1024"], quality_gate=line["quality_gate"],
        **{f"{path}_launches": n for path, n in launches.items()})
    return launches


# ------------------------------------------------ the JAX repo's twins

def _entry_batch_decode(dev):
    """examples/torch_batch_decode.py at its defaults: S = 8, 25 frames,
    the non-plan pipeline; against the plan pipeline."""
    twin = load_script("examples/torch_batch_decode.py")
    _reset_launches()
    pkts, out = twin.run(S_EXAMPLE, device=dev)
    torch.cuda.synchronize()
    launches = deemph.deemphasis_launches
    steps = _path_launches("example_batch_decode", len(pkts),
                           executor=False)
    check(launches == len(pkts) == twin.N_FRAMES,
          f"batch decode: {launches} deemphasis launches in {len(pkts)} "
          "steps: one a step expected")
    got = torch.stack(out).cpu().numpy()
    check(got.shape == (len(pkts), S_EXAMPLE, FRAME, 2),
          f"batch decode pcm {got.shape}")
    check(bool(np.isfinite(got).all()), "batch decode: non-finite pcm")
    plan = CeltStreamPipeline(S_EXAMPLE, use_plan=True, device=dev)
    want = np.stack([plan.step([p[1:]] * S_EXAMPLE).cpu().numpy()
                     for p in pkts])
    err = float(np.abs(got - want).max())
    check(err <= GOLDEN_TOL, f"batch decode: {err} from the plan pipeline")
    say("entry_batch_decode", streams=S_EXAMPLE, frames=len(pkts),
        packet_bytes=sum(map(len, pkts)), worst_abs_err_vs_plan=err,
        bar=GOLDEN_TOL, peak=float(np.abs(got).max()),
        deemphasis_launches=launches, kernel_launches=steps)
    return launches


@contextlib.contextmanager
def _periods():
    """The float pitch period of every DeepPlcState.conceal in the block
    (its one PitchDNN step: through the kernel on the card), by the type
    of device it ran on."""
    seen = {"cuda": [], "cpu": []}
    inner = deep_plc.DeepPlcState.conceal

    def recorded(self, n_samples):
        out = inner(self, n_samples)
        if self.fargan_model is not None:
            seen[self.device.type].append(float(self.last_period[0]))
        return out

    deep_plc.DeepPlcState.conceal = recorded
    try:
        yield seen
    finally:
        deep_plc.DeepPlcState.conceal = inner


def _entry_dred(dev):
    """examples/torch_dred_loss_recovery.py on the card against its decode
    loop on the CPU over the same packets, with the same weights."""
    from mousiki_tpu_torch import OpusDecoder
    twin = load_script("examples/torch_dred_loss_recovery.py")
    with _periods() as periods:
        t = time.perf_counter()
        pkts, pcm, how = twin.run(device=dev)
        card_s = time.perf_counter() - t
        cpu = twin.synthetic_models("cpu")
        host_pkts, host_pcm, _ = twin.run(models=cpu, device="cpu")
        periods["cpu"].clear()          # the CPU run's own packets aside
        dec = OpusDecoder(twin.FS, 1)
        dec.set_deep_plc(cpu["fargan"], cpu["pitch"])
        dec.set_dred_models(cpu["dec"])
        want, want_how = twin.recover(dec, pkts, set(twin.LOST))
    check(how == want_how == {twin.LOST: "dred"},
          f"DRED recovery: {how} on the card, {want_how} on the CPU")
    check(pcm.shape == want.shape and bool(np.isfinite(pcm).all()),
          f"DRED recovery pcm {pcm.shape}")
    card_p, cpu_p = periods["cuda"], periods["cpu"]
    check(len(card_p) == len(cpu_p) > 0,
          f"PitchDNN ran {len(card_p)} times on the card, {len(cpu_p)} on "
          "the CPU")
    worst_period = max(abs(g - c) for g, c in zip(card_p, cpu_p))
    check(worst_period <= PERIOD_TOL,
          f"DRED recovery: PitchDNN periods {worst_period} from the CPU's")
    flips = [dict(card=g, cpu=c, cpu_distance_from_integer=abs(c - round(c)))
             for g, c in zip(card_p, cpu_p) if int(g) != int(c)]
    for flip in flips:
        print(f"[entry_dred] period flip {flip}", flush=True)
        check(flip["cpu_distance_from_integer"] < PERIOD_TOL,
              f"period flip far from an integer: {flip}")
    # before the first lost frame no network shapes the PCM, so a flip
    # excuses nothing there
    head = twin.LOST[0] * FRAME
    err_head = float(np.abs(pcm[:head] - want[:head]).max())
    check(err_head <= NEURAL_PCM_TOL, f"DRED recovery: PCM {err_head} from "
          "the CPU decode before the loss")
    err = float(np.abs(pcm - want).max())
    if not flips:
        check(err <= NEURAL_PCM_TOL, f"DRED recovery: PCM {err} from the "
              "CPU decode of the same packets")
    equal = sum(a == b for a, b in zip(pkts, host_pkts)) / len(pkts)
    say("entry_dred", frames=len(pkts), lost=list(twin.LOST),
        recovered="dred", worst_abs_err_vs_cpu=err,
        worst_abs_err_vs_cpu_before_loss=err_head, bar=NEURAL_PCM_TOL,
        worst_period_diff=worst_period, period_flips=len(flips),
        pitch_calls=len(card_p),
        packets_equal_to_cpu_run=equal,
        worst_abs_err_vs_cpu_run=(float(np.abs(pcm - host_pcm).max())
                                  if equal == 1 else None),
        card_seconds=round(card_s, 2))


def _entry_single_stream():
    """The single-stream twins' chain, once, through their main functions
    (host numpy, as in the references; tests/test_torch_examples.py holds
    them to the JAX examples byte for byte): libopusenc writes an .opus
    file, decode_ogg decodes it (its raw f32 stdout captured), the seeking
    example reads a window from it and from a file of its own; then the
    trivial round trip."""
    twins = {n: load_script(f"examples/torch_{n}.py") for n in (
        "libopusenc_example", "decode_ogg", "opusfile_seeking_example",
        "trivial_example")}
    text, raw = io.StringIO(), io.TextIOWrapper(io.BytesIO())
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(text):
        path = os.path.join(tmp, "tone.opus")
        twins["libopusenc_example"].main([path])
        with contextlib.redirect_stdout(raw), \
                contextlib.redirect_stderr(io.StringIO()):
            twins["decode_ogg"].main([path])
        raw.flush()
        twins["opusfile_seeking_example"].main([path])
        twins["opusfile_seeking_example"].main([])
        twins["trivial_example"].main()
        with open(path, "rb") as fh:
            opus = fh.read()
        lines = text.getvalue().replace(tmp, "TMP").splitlines()
    f32 = raw.buffer.getvalue()
    pcm = np.frombuffer(f32, "<f4")
    check(len(pcm) > 0 and bool(np.isfinite(pcm).all())
          and b"ARTIST=mousiki_tpu" in opus,
          f"single-stream chain: {len(f32)} f32 bytes, {len(opus)} .opus "
          "bytes")
    check(len(lines) == 4 and lines[0] == "wrote TMP/tone.opus"
          and all(line.startswith("pcm_total=") for line in lines[1:3])
          and lines[3].startswith("encoded+decoded 48000 samples"),
          f"single-stream chain printed {lines}")
    return dict(opus_bytes=len(opus), f32_bytes=len(f32), lines=lines)


def _entry_codec_tools():
    """codec_bench (packets, encode, decode) and opus_packet_tool (encode,
    decode), once, on 10 frames of stereo PCM (host numpy, as in the
    references; tests/test_torch_tools.py holds their files to the JAX
    tools' byte for byte)."""
    bench_tool = load_script("tools/torch_codec_bench.py")
    packet_tool = load_script("tools/torch_opus_packet_tool.py")
    sig = oracle.make_test_signal(FRAME * 10, 2, seed=11)
    once = ["--warmup", "0", "--measure", "1"]
    text = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(text):
        pcm, corpus = os.path.join(tmp, "in.s16"), os.path.join(tmp, "c.bin")
        pkt, dec = os.path.join(tmp, "p.bin"), os.path.join(tmp, "d.s16")
        with open(pcm, "wb") as fh:
            fh.write(oracle.float_to_i16(sig).astype("<i2").tobytes())
        bench_tool.main(["packets", "--input", pcm, "--output", corpus])
        for cmd, inp in (("encode", pcm), ("decode", corpus)):
            bench_tool.main([cmd, "--input", inp, "--format", "csv"] + once)
        packet_tool.main(["encode", pcm, pkt])
        packet_tool.main(["decode", pkt, dec])
        files = []
        for path in (corpus, pkt, dec):
            with open(path, "rb") as fh:
                files.append(fh.read())
    lines = text.getvalue().splitlines()
    check(lines[0].startswith("wrote 10 packets to ")
          and lines[1] == lines[3] == ("median_ns_per_frame,p95_ns_per_frame,"
                                       "median_packets_per_sec,"
                                       "median_realtime_x")
          and lines[5:] == ["encoded 10 packets", "decoded 10 packets"],
          f"codec tools printed {lines}")
    corpus, pkt, dec = files
    check(len(dec) == 2 * 2 * FRAME * 10, f"decoded {len(dec)} bytes")
    return dict(corpus_bytes=len(corpus), opuspkt1_bytes=len(pkt),
                host_encode_csv=lines[2], host_decode_csv=lines[4])


def _entry_dnn_blob():
    """build_dnn_blob on a synthetic opus_data C source."""
    from mousiki_tpu_torch.models.nnet import parse_weight_blob
    tool = load_script("tools/torch_build_dnn_blob.py")
    src = ("const float dec_dense1_bias[3] = {1.0f, -2.5f, 0.125f};\n"
           "const opus_int8 dec_gru1_input_weights[4] = {1, -2, 127, -128};"
           "\n")
    with tempfile.TemporaryDirectory() as tmp:
        os.mkdir(os.path.join(tmp, "opus_data"))
        with open(os.path.join(tmp, "opus_data", "fargan_data.c"), "w") as fh:
            fh.write(src)
        out = os.path.join(tmp, "blob.bin")
        tool.main([os.path.join(tmp, "opus_data"), out])
        with open(out, "rb") as fh:
            blob = fh.read()
    arrays = parse_weight_blob(blob)
    check(sorted(arrays) == ["dec_dense1_bias", "dec_gru1_input_weights"]
          and np.frombuffer(arrays["dec_dense1_bias"], "<f4").tolist()
          == [1.0, -2.5, 0.125]
          and np.frombuffer(arrays["dec_gru1_input_weights"],
                            np.int8).tolist() == [1, -2, 127, -128],
          f"build_dnn_blob: {arrays}")
    return dict(blob_bytes=len(blob))


def _entry_bench_lockstep(dev, card):
    """tools/torch_bench_lockstep.py at S = 256: the first step and one
    trial of one step; against the plan pipeline's first step."""
    probe = load_script("tools/torch_bench_lockstep.py")
    _reset_launches()
    with _emission_walks() as walks, \
            _step_calls() as (staged, assembled, combed):
        res = probe.run(S_MAIN, device=dev, iters=1, trials=1)
    torch.cuda.synchronize()
    launches = deemph.deemphasis_launches
    leaf = _path_launches("tool_bench_lockstep", 2, lockstep=True)
    _emission_walk_times("tool_bench_lockstep", walks)
    _own_step_rows("tool_bench_lockstep", staged, assembled, combed)
    check(launches == 2, f"lockstep probe: {launches} deemphasis launches "
          "in 2 steps: one a step expected")
    n_ok = int(res["ok"].sum())
    check(n_ok == S_MAIN, f"lockstep probe: {S_MAIN - n_ok} lanes not ok")
    pays = probe.load_payloads()
    plan = CeltStreamPipeline(S_MAIN, use_plan=True, device=dev)
    want = plan.step([pays[s % len(pays)] for s in range(S_MAIN)])
    got = res["pcm"]
    check(got.shape == want.shape == (S_MAIN, FRAME, 2)
          and bool(torch.isfinite(got).all()),
          f"lockstep probe pcm {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    check(err <= GOLDEN_TOL,
          f"lockstep probe: first step {err} from the plan pipeline")
    say("entry_bench_lockstep", streams=S_MAIN, channels=probe.C,
        first_step_s=res["first_s"], ms_per_step=res["step_ms"][0],
        realtime_x=res["realtime_x"][0], worst_abs_err_vs_plan=err,
        bar=GOLDEN_TOL, lanes_ok=n_ok, deemphasis_launches=launches,
        kernel_launches=leaf, card=repr(card))
    return launches


def phase_entry_points(dev, card):
    """The twins of the JAX repo's examples and tools on the card."""
    seconds, launches = {}, {}

    def part(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    launches["example_batch_decode"] = part(
        "batch_decode", _entry_batch_decode, dev)
    part("dred_loss_recovery", _entry_dred, dev)
    say("entry_single_stream", **part("single_stream", _entry_single_stream))
    say("entry_codec_tools", **part("codec_tools", _entry_codec_tools))
    say("entry_build_dnn_blob", **part("build_dnn_blob", _entry_dnn_blob))
    launches["tool_bench_lockstep"] = part(
        "bench_lockstep", _entry_bench_lockstep, dev, card)
    say("entry_points", **{f"{k}_seconds": v for k, v in seconds.items()})
    return launches


def _phase(name, fn, *args):
    """Run one phase and keep its wall seconds."""
    t = time.perf_counter()
    out = fn(*args)
    RESULTS.setdefault("phase_seconds", {})[name] = round(
        time.perf_counter() - t, 1)
    return out


def main() -> int:
    global OUT_DIR
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for the measurements (JSON) "
                    "and profiler tables")
    args = ap.parse_args()
    OUT_DIR = args.out
    t_start = time.perf_counter()
    check_no_jax_package()
    dev, card = phase_device()
    if OUT_DIR is not None:
        os.makedirs(OUT_DIR, exist_ok=True)
    _phase("build", phase_build)
    mesh, s_mesh, one_card = mesh_layout(dev)
    mesh_shapes = ((s_mesh // mesh.size, 2, FRAME),
                   (s_mesh // mesh.size, 1, FRAME))
    table = _phase("kernel", phase_kernel, dev,
                   KERNEL_SHAPES + tuple(sh for sh in mesh_shapes
                                         if sh not in KERNEL_SHAPES))
    streams = load_stereo_celt()
    mono = load_mono_mix()
    set_plan_profile(*SERVING_PROFILE)
    shard = s_mesh // mesh.size
    # (S, C) of each path's decode step, for the leaf stage, band assembly
    # and comb filter rows (the lockstep paths' rows time their own calls)
    step_widths = {"celt": (S_MAIN, 2), "mixed": (S_MAIN, 1),
                   "celt_lockstep": (S_MAIN, 2),
                   "celt_lockstep_mono": (S_MAIN, 1),
                   "celt_mesh": (shard, 2), "mixed_mesh": (shard, 1),
                   "bench_e2e": (S_MAIN, 2), "bench_e2e_s1024": (S_WIDE, 2),
                   "bench_gate": (bench.GATE_STREAMS, 2),
                   "encode_quality": (len(quality.CELT_RATES), 2),
                   "tool_bench_lockstep": (S_MAIN, 2),
                   "celt_python_host": (S_PYHOST, 2),
                   "example_batch_decode": (S_EXAMPLE, 2)}
    no_executor = {"celt_python_host", "example_batch_decode"}
    executor_widths = {w for path, w in step_widths.items()
                       if path not in no_executor}
    leaf_table = _phase("leaf_kernels", phase_leaf_kernels, dev, streams,
                        mono, executor_widths)
    step_table = _phase("step_kernels", phase_step_kernels, dev, streams,
                        mono, {"band_assembly": executor_widths,
                               "comb_filter": set(step_widths.values())})
    step_table["pvq_leaf_stage"] = leaf_table
    plc_table = _phase("plc_kernel", phase_plc_kernel, dev, streams, mono, {
        (S_MAIN, 2), (S_WIDE, 2), (S_MAIN, 1), (S_WIDE, 1), (shard, 2),
        (shard, 1)})
    nsq_table = _phase("nsq_kernels", phase_nsq_kernels, dev, NSQ_WIDTHS)
    syn_table = _phase("silk_synthesis_kernel", phase_silk_synthesis_kernel,
                       dev, mono)
    neural_table = _phase("neural_kernels", phase_neural_kernels, dev)
    _record_frames()
    _guard_plc()
    n_celt, _ = _phase("main_path", phase_main_path, dev, streams)
    _phase("loss", phase_loss, dev, streams)
    _phase("celt_modes", phase_celt_modes, dev, streams)
    n_mixed = _phase("mixed_main", phase_mixed_main, dev, mono)
    _phase("device_silk", phase_device_silk, dev, mono)
    _phase("mixed_loss", phase_mixed_loss, dev, mono)
    _phase("encode_front", phase_encode_front, dev, streams)
    _phase("encode_celt", phase_encode_celt, dev, streams)
    nsq_batches = _phase("silk_nsq", phase_silk_nsq, dev)
    _phase("encode_silk", phase_encode_silk, dev, mono)
    n_quality = _phase("encode_quality", phase_encode_quality, dev, card)
    _phase("timing", phase_timing, dev, streams, mono)
    _phase("encode_timing", phase_encode_timing, dev, streams, nsq_batches)
    _phase("neural_conceal", phase_neural_conceal, dev)
    dreds = _phase("rdovae_decode", phase_rdovae_decode, dev)
    _phase("dred_encode", phase_dred_encode, dev)
    _phase("neural_timing", phase_neural_timing, dev, dreds)
    n_pyhost = _phase("python_host", phase_python_host, dev, streams)
    _phase("single_stream", phase_single_stream)
    _phase("deep_plc", phase_deep_plc, dev)
    n_lockstep = _phase("lockstep", phase_lockstep, dev, streams, mono)
    n_mesh_celt, n_mesh_mixed = _phase(
        "mesh", phase_mesh, dev, streams, mono, mesh, s_mesh, one_card)
    _phase("libopus", phase_libopus, dev, streams)
    n_bench = _phase("bench", phase_bench, dev)
    n_entry = _phase("entry_points", phase_entry_points, dev, card)
    # one row for each path's shape: the path's launches (counted from 0
    # just before it ran) beside what phase 3 measured at that shape
    kernels = {"kernels": [{
        "name": "deemphasis_pcm", "route": "cuda",
        "source": "mousiki_tpu_torch/csrc/deemphasis.cu",
        "replaces": "mousiki_tpu/ops/pallas_kernels.py:23",
        "path": path, "shape": list(shape), "launches": launches,
        "max_abs_err": table[shape]["max_abs_err"],
        "ms": table[shape]["kernel_device_ms"],
        # the input as the path leaves it (in L2) beats the HBM bound
        # where it fits in L2 with its output, as at (1024, 2, 960)
        "ms_l2_evicted": table[shape]["kernel_device_ms_l2_flushed"],
        "plain_ms": table[shape]["plain_device_ms"],
        "bound_ms": table[shape]["bound_ms"],
        "bound_by": table[shape]["bound_by"],
        # no PyTorch call computes a first-order IIR
        "library_ms": None}
        for path, shape, launches in (
            ("celt", CELT_SHAPE, n_celt), ("mixed", MIXED_SHAPE, n_mixed),
            ("celt_python_host", PYHOST_SHAPE, n_pyhost),
            ("celt_lockstep", CELT_SHAPE, n_lockstep["celt_lockstep"]),
            ("celt_lockstep_mono", MIXED_SHAPE,
             n_lockstep["celt_lockstep_mono"]),
            ("celt_mesh", mesh_shapes[0], n_mesh_celt),
            ("mixed_mesh", mesh_shapes[1], n_mesh_mixed),
            ("bench_e2e", CELT_SHAPE, n_bench["bench_e2e"]),
            ("bench_e2e_s1024", WIDE_SHAPE, n_bench["bench_e2e_s1024"]),
            ("bench_gate", GATE_SHAPE, n_bench["bench_gate"]),
            ("encode_quality", QUALITY_SHAPE, n_quality),
            ("example_batch_decode", EXAMPLE_SHAPE,
             n_entry["example_batch_decode"]),
            ("tool_bench_lockstep", CELT_SHAPE,
             n_entry["tool_bench_lockstep"]))]}
    # one row for the walk on each lockstep path: the path's launches
    # beside the times of its plan emission's three launches (one a tier)
    # in a step, measured on that run's planes
    kernels["kernels"] += [{
        "name": name, "route": "cuda",
        "source": "mousiki_tpu_torch/csrc/pvq_leaves.cu",
        "replaces": LEAF_KERNELS[name][0], "path": path,
        "launches": counts[name],
        **{key: EMISSION_WALK[path][key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")},
        # no PyTorch call decodes CWRS
        "library_ms": None}
        for path, counts in PATH_LAUNCHES.items() for name in LEAF_KERNELS
        if name in counts]
    # one row for each step kernel and path that runs it: the path's
    # launches beside the times of a step's launches at the path's width
    # (phases 3b and 3c), or of the lockstep step's own calls (phases 22,
    # 26)

    def own_row(path, name):
        own = OWN_STEP_ROWS.get(path)
        return own[name] if own else step_table[name][step_widths[path]]

    kernels["kernels"] += [{
        "name": name, "route": "cuda", "source": STEP_KERNELS[name][2],
        "replaces": STEP_KERNELS[name][0], "path": path,
        "launches": counts[name],
        **{key: own_row(path, name)[key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")},
        # no PyTorch call decodes CWRS, applies the spreading rotation,
        # assembles CELT bands or runs the comb filter
        "library_ms": None}
        for path, counts in PATH_LAUNCHES.items() for name in STEP_KERNELS
        if name in counts]
    # one row for each path that ran the concealment's rows at a width
    # phase 3d timed: its launches (one a lossy step) beside the times of
    # a launch at that width with ~10% of the streams lost
    kernels["kernels"] += [{
        "name": "plc_rows", "route": "cuda", "source": PLC_KERNEL[1],
        "replaces": PLC_KERNEL[0], "path": path, "launches": n,
        **{key: plc_table[(S, C)][key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")},
        "chain_ms": plc_table["chain"]["ms"],
        # no PyTorch call computes a clamped order-24 IIR
        "library_ms": None}
        for (path, S, C), (_, _, n) in sorted(PLC_LAUNCHES.items())
        if n and (S, C) in plc_table]
    # one row for each path and width that ran a quantizer kernel: its
    # launches (one a device quantizer call) beside phase 3e's times at
    # that width
    for name, paths in NSQ_LAUNCHES.items():
        check(all(S in nsq_table[name] for _, S in paths),
              f"{name}: widths {sorted({S for _, S in paths})} on the "
              f"paths, phase 3e timed {sorted(nsq_table[name])}")
    kernels["kernels"] += [{
        "name": name, "route": "cuda", "source": NSQ_SOURCE,
        "replaces": NSQ_KERNELS[name][0], "path": path, "launches": n,
        **{key: nsq_table[name][S][key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "chain_us_a_sample")},
        # no PyTorch call computes a noise-shaping quantizer
        "library_ms": None}
        for name, paths in NSQ_LAUNCHES.items()
        for (path, S), n in sorted(paths.items())]
    # one row for each path of phase 8 that ran the SILK synthesis
    # kernel: its launches (one a step) beside phase 3f's times on that
    # path's own calls at S = 256
    kernels["kernels"] += [{
        "name": "silk_synthesis", "route": "cuda", "source": SYN_KERNEL[2],
        "replaces": SYN_KERNEL[0], "path": path, "launches": n,
        **{key: syn_table[label][key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "chain_us_a_sample")},
        # no PyTorch call computes an LTP and an order-16 IIR
        "library_ms": None}
        for path, (n, label) in SYN_LAUNCHES.items()]
    # one row for each path of phases 15, 16, 18 and 21 that ran a neural
    # kernel: its launches beside phase 3g's times of a call of that shape
    kernels["kernels"] += [{
        "name": name, "route": "cuda", "source": NEURAL_KERNELS[name][2],
        "replaces": NEURAL_KERNELS[name][0], "path": path, "launches": n,
        **{key: neural_table[label][key]
           for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by")},
        # no PyTorch call computes a FARGAN subframe chain or an RDOVAE
        # qframe
        "library_ms": None}
        for (path, name), (n, label) in NEURAL_LAUNCHES.items()]
    say("plc_launches", **{f"{path}_S{S}_C{C}": v for (path, S, C), v
                           in sorted(PLC_LAUNCHES.items())})
    # the frame sizes the paths decoded, all among those 3c checked
    checked = [*SHORT_FRAMES, FRAME]
    check(FRAMES_DECODED <= set(checked),
          f"paths decoded frame sizes {sorted(FRAMES_DECODED)}, phase 3c "
          f"checked {checked}")
    say("step_kernel_frames", decoded_by_paths=sorted(FRAMES_DECODED),
        checked=checked, lm0_2_on_paths=bool(FRAMES_DECODED - {FRAME}))
    RESULTS["kernels"] = kernels
    say("device_ms_by_events", count=len(EVENT_TIMED), timings=EVENT_TIMED)
    say("run", seconds=round(time.perf_counter() - t_start, 1),
        **RESULTS["phase_seconds"])
    if OUT_DIR is not None:
        with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
            json.dump(RESULTS, fh, indent=1, default=str)
    print(card, flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
