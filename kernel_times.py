#!/usr/bin/env python3
"""Time the packed model's kernels K1-K3 of one checkout of the port on one
NVIDIA GPU, tumor-only, at the main path's 128-row request and at 65,536
rows, in both regimes.

    python3 kernel_times.py [--checkout DIR] [--label NAME] [--b1 STREAM]

DIR (default: this script's directory) is the root of a checkout whose
``uvc_tpu_torch`` is imported and whose kernels are built there, so two
commits can be timed in turns on the same card from one call, e.g. a
parent unpacked with ``git archive`` beside this tree: parent, change,
change, parent.  The inputs are chip_smoke.py's phase-3 request
(``model/example.py``'s 4,096-row payload, seed 2, tiled 16 times).
Times are CUDA-event means over 200 launches (128 rows) or 20 (65,536
rows) after one warm-up, each launch from the same inputs; K2 and K3 read
K1's (and K2's) leaves as the model chain leaves them.  At 128 rows the
host's launch rate bounds the event mean, so the kernels' own device
time there comes from torch.profiler's trace of the card as well
(``device_ms``: the mean kernel duration of the launches the trace
keeps, at least 180 of 200; chip_smoke.device_ms).  With ``--b1 STREAM``
it also times the checkout's dc_segments, both stages of a call, on
chip_smoke.py phase 9's random 2^20-row table and on the real fragment
stream that phase 9 saved at STREAM (an .npz), from tables sorted by the
plain versions, so two checkouts time the same inputs: a CUDA-event mean
over 20 calls and the device time of a call over 200, summed over the
records of the kernel family that the checkout's source defines
(chip_smoke.b1_segment_times, chip_smoke.seg_family).  Prints the card, ptxas's registers,
stack and spills of each model kernel where this call built the
checkout's library, and one JSON line.
"""

import argparse
import json
import os
import sys

from chip_smoke import MAIN_ROWS, N_ROWS, TILE, b1_segment_times, \
    card_line, cuda_ms, device_ms, ptxas_table


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkout", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--b1", default=None, metavar="STREAM",
                    help="also time dc_segments, on this real stream (.npz)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("kernel_times: torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.abspath(args.checkout))
    from uvc_tpu_torch.backend import TorchModelBackend
    from uvc_tpu_torch.kernels import build, capitals_vq, dpv, qual_tail
    from uvc_tpu_torch.model.example import (example_model_payload,
                                             packed_request)
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    build.load()
    label = args.label or args.checkout
    if "ptxas" not in build.BUILD_INFO:
        print(f"{label}: library {build.BUILD_INFO['path']} was built "
              "before; ptxas not run")
    for e in ptxas_table(build.BUILD_INFO.get("ptxas", "")):
        if e["name"].split("_kernel")[0] in build.KERNELS:
            print(f"{label} ptxas {e['name']}: {e.get('registers')} "
                  f"registers, stack {e.get('stack')} B, spill stores "
                  f"{e.get('spill_stores')} B, spill loads "
                  f"{e.get('spill_loads')} B")
    arrays, cand, cfg = example_model_payload(n_pos=TILE, seed=2,
                                              pad_to=TILE)
    reps = N_ROWS // TILE
    arrays = {k: np.concatenate([v] * reps, axis=0) for k, v in arrays.items()}
    cand = np.concatenate([cand] * reps, axis=0)
    stages = (("capitals_vq", capitals_vq.capitals_vq),
              ("dpv", dpv.dpv), ("qual_tail", qual_tail.qual_tail))
    out, dev_ms = {}, {}
    for regime in ("f32", "f64"):
        pi_np, _pf, ispec, _, _ = packed_request(arrays, cand, regime)
        model = TorchModelBackend(dev, regime).model(cfg)
        lay = model.bind(ispec)
        for rows in (MAIN_ROWS, N_ROWS):
            pi = torch.from_numpy(pi_np[:rows]).to(dev)
            oi = torch.zeros((rows, lay.coi), dtype=model.regime.itype,
                             device=dev)
            of = torch.zeros((rows, lay.cof), dtype=model.regime.ftype,
                             device=dev)
            for name, kernel in stages:
                key = f"{name} {regime} {rows}"
                out[key] = cuda_ms(lambda: kernel(pi, oi, of, model),
                                   200 if rows == MAIN_ROWS else 20)
                t_dev = device_ms(lambda: kernel(pi, oi, of, model), 200,
                                  {f"{name}_kernel": 1}) \
                    if rows == MAIN_ROWS else None
                if t_dev is not None:
                    dev_ms[key] = t_dev
            del pi, oi, of
            torch.cuda.empty_cache()
    for k, v in out.items():
        t_dev = f", device {dev_ms[k]:.4f} ms" if k in dev_ms else ""
        print(f"{label} {k}: {v:.4f} ms{t_dev}")
    b1 = b1_segment_times(dev, args.b1) if args.b1 else {}
    for k, (ms, t_dev) in b1.items():
        print(f"{label} dc_segments {k}: {ms:.4f} ms, device "
              + (f"{t_dev:.4f} ms" if t_dev is not None else "not measured"))
    print(json.dumps({"checkout": label, "card": card, "ms": out,
                      "device_ms": dev_ms, "b1": b1}))


if __name__ == "__main__":
    main()
