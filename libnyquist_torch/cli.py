"""`libnyquist-torch` console entry point (pyproject [project.scripts]).

The reference's example app surface (reference: examples/src/Main.cpp:
load, print `len / sum`, verify the Opus oracle checksums, optional
save) plus the added SRC and URL sources, decoding on the card:

  libnyquist-torch FILE_OR_URL [--save OUT.wav|OUT.opus] [--rate HZ]
                               [--check] [--info]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

ORACLE_PAIRS = {(403, 21_472_602), (40, 127_712_488), (719, 21_472_602)}


def main(argv=None, device=None) -> int:
    """Run the console command on ``argv`` (default: the process's
    arguments); the decode, resample and save run on ``device`` (CUDA
    unless the caller names another)."""
    import libnyquist_torch as nq
    from libnyquist_torch.audio_data import PCMFormat
    from libnyquist_torch.device import resolve_device
    from libnyquist_torch.encoders import EncoderParams, encode_wav_to_disk

    ap = argparse.ArgumentParser(
        prog="libnyquist-torch", description=__doc__)
    ap.add_argument("file", help="audio file path or http(s):// URL")
    ap.add_argument("--save", help="write decoded audio (.wav / .opus)")
    ap.add_argument("--rate", type=int,
                    help="resample to this rate before saving")
    ap.add_argument("--check", action="store_true",
                    help="verify the reference oracle checksums")
    ap.add_argument("--info", action="store_true",
                    help="print stream info only (lazy; no full decode)")
    args = ap.parse_args(argv)
    device = resolve_device(device)
    is_url = args.file.startswith(("http://", "https://"))

    if args.info:
        r = (nq.open_url(args.file, device=device) if is_url
             else nq.seek_reader(args.file, device=device))
        print(f"{type(r).__name__}: {r.pcm_total()} samples/ch")
        return 0

    t0 = time.perf_counter()
    if is_url:
        audio = nq.load_url(args.file, device=device)
    else:
        audio = nq.load(args.file, device=device)
    dt = time.perf_counter() - t0
    total = float(np.asarray(audio.samples, np.float64).sum())
    print(f"len: {audio.sample_count} sum: {total:f}")
    print(f"[{dt*1e3:.1f} ms] {audio.channel_count}ch "
          f"{audio.sample_rate}Hz {audio.length_seconds:.2f}s")

    if args.rate and args.rate != audio.sample_rate:
        ch = audio.channel_count
        per = np.asarray(audio.samples).reshape(-1, ch).T
        res = nq.resample(per, audio.sample_rate, args.rate,
                          device=device).cpu().numpy()
        audio.samples = res.T.reshape(-1).astype(np.float32)
        audio.sample_rate = args.rate
        print(f"resampled -> {args.rate}Hz, {audio.sample_count} samples")

    if args.check and (int(total), audio.sample_count) not in ORACLE_PAIRS:
        print("wrong results!  save to wave file")
        encode_wav_to_disk(
            EncoderParams(audio.channel_count, PCMFormat.PCM_FLT),
            audio, "opusdec.wav", device)
        return 1

    if args.save:
        params = EncoderParams(audio.channel_count, PCMFormat.PCM_16)
        if args.save.lower().endswith(".opus"):
            from libnyquist_torch.encoders import encode_opus_to_disk

            err = encode_opus_to_disk(params, audio, args.save, device)
        else:
            err = encode_wav_to_disk(params, audio, args.save, device)
        if err:
            print(f"save failed: {err}")
            return 1
        print(f"saved {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
