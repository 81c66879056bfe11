"""DRED loss recovery with the PyTorch/CUDA port: encode speech with deep
redundancy, drop packets in transit, and recover the lost audio from the
next packet's embedded DRED payload through the neural concealment path
(the twin of examples/dred_loss_recovery.py).

    python3 examples/torch_dred_loss_recovery.py [--device cuda|cpu]

--device defaults to cuda (which raises without a GPU). Every network runs
there: the RDOVAE encoder inside the copied OpusEncoder, the RDOVAE
decoder, PitchDNN and FARGAN inside the copied OpusDecoder. Each model is
built on that device and handed in, so nothing falls to a default device.
The weights are synthetic, drawn from seeded torch Generators (FARGAN 0,
RDOVAE encoder 0, decoder 1, PitchDNN 3: the seeds of the port's own
defaults); load real ones with the models' from_blob.
"""

import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # runnable from anywhere

import argparse

import numpy as np
import torch

from mousiki_tpu_torch._device import from_cli
from mousiki_tpu_torch.hostcodec.opus_decoder import OpusDecoder
from mousiki_tpu_torch.hostcodec.opus_encoder import APP_VOIP, OpusEncoder
from mousiki_tpu_torch.models import deep_plc, fargan
from mousiki_tpu_torch.models import dred as rdovae

FS, N_FRAMES = 48000, 25
LOST = (12, 13)     # 40 ms burst loss


def synthetic_models(device) -> dict:
    """The four networks with seeded synthetic weights, on `device`."""
    def gen(seed):
        return torch.Generator().manual_seed(seed)
    return {"enc": rdovae.random_enc(gen(0), device=device),
            "dec": rdovae.random_dec(gen(1), device=device),
            "fargan": fargan.random_model(gen(0), device=device),
            "pitch": deep_plc.random_pitchdnn(gen(3), device=device)}


def voiced_signal(n_frames: int = N_FRAMES) -> np.ndarray:
    """A gliding, amplitude-modulated tone: (960 * n_frames, 1) float32."""
    t = np.arange(960 * n_frames) / FS
    f0 = 140 + 25 * np.sin(2 * np.pi * 2.0 * t)
    return (0.35 * np.sin(2 * np.pi * np.cumsum(f0) / FS)
            * (0.6 + 0.4 * np.sin(2 * np.pi * 3.5 * t) ** 2)
            ).astype(np.float32)[:, None]


def encode(enc, sig: np.ndarray, n_frames: int) -> list:
    """n_frames 20 ms packets of `enc`, an OpusEncoder with DRED on."""
    packets = [enc.encode(sig[f * 960:(f + 1) * 960], 960)
               for f in range(n_frames)]
    dred_bytes = sum(len(p) for p in packets)
    print(f"encoded {n_frames} packets, {dred_bytes} bytes total "
          f"(DRED embedded as extension id 126 in packet padding)")
    return packets


def recover(dec, packets: list, lost) -> tuple[np.ndarray, dict]:
    """Decode `packets` with `dec`, an OpusDecoder with deep PLC, the
    frames in `lost` dropped and recovered from the DRED of the next
    received packet (classic PLC where it carries none). Returns the PCM
    and, for each gap, how it was recovered ("dred" or "plc")."""
    out, how = [], {}
    f, n_frames = 0, len(packets)
    while f < n_frames:
        if f in lost:
            # find the next received packet carrying DRED for this gap
            nxt = f
            while nxt in lost:
                nxt += 1
            dred = dec.dred_parse(packets[nxt])
            gap = [g for g in range(f, nxt)]
            if dred is not None:
                dec.dred_process(dred)
                for i, g in enumerate(gap):
                    off = 2 * (len(gap) - i)  # 10 ms units before "now"
                    out.append(dec.dred_decode(dred, off, 960))
                print(f"frames {gap}: recovered via DRED "
                      f"({dred.nb_latents} latents in packet {nxt})")
                how[tuple(gap)] = "dred"
            else:
                for g in gap:
                    out.append(dec.decode(None, 960))
                print(f"frames {gap}: no DRED found, classic PLC")
                how[tuple(gap)] = "plc"
            f = nxt
            continue
        out.append(dec.decode(packets[f], 960))
        f += 1
    pcm = np.concatenate(out)
    print(f"decoded {len(pcm)} samples, rms={np.sqrt((pcm ** 2).mean()):.3f}")
    return pcm, how


def run(n_frames: int = N_FRAMES, lost=LOST, models=None, *, device):
    """The example's body on `device` (models: synthetic_models' dict, by
    default made there). Returns (packets, pcm, how each gap was
    recovered)."""
    if models is None:
        models = synthetic_models(device)
    enc = OpusEncoder(FS, 1, APP_VOIP)
    enc.set_bitrate(24000)
    # embed ~400 ms of redundancy per packet
    enc.set_dred_duration(40, model=models["enc"])
    packets = encode(enc, voiced_signal(n_frames), n_frames)
    dec = OpusDecoder(FS, 1)
    dec.set_deep_plc(models["fargan"], models["pitch"])
    dec.set_dred_models(models["dec"])
    pcm, how = recover(dec, packets, set(lost))
    return packets, pcm, how


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    run(device=from_cli(args.device))


if __name__ == "__main__":
    main()
