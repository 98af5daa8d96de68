"""The card's numerics against the CPU's f64 on the f32-parity workload:
the counterpart of tools/tpu_record_diff.py.

    python -m uvc_tpu_torch.utils.record_diff [--device cuda|cpu] [--keep-going]

It builds the workload of tests/test_f32_parity.py in a temporary
directory (``goldens.build_f32_parity_input``: 12 kbp at depth 120, SNVs
down to AF 0.06) and runs the port's uvc1 at ``-t 1`` on it, one
subprocess a leg, the legs side by side:

  - golden: ``--device cpu --model-regime f64`` (the golden regime);
  - device: ``--device <device> --model-regime f32``;
  - device_f64 (``--device cuda`` only): ``--device cuda --model-regime
    f64``.  The card has FP64, so this body must be byte-identical to the
    golden leg's.

The device leg is held to the golden leg under the f32 contract
(``goldens.record_diff``: the same records and FILTERs, QUAL within 0.51,
every numeric FORMAT value within 1, string fields equal, at least 4
records).  Each divergence is printed (at most 40), then ``RECORD-DIFF:
OK`` or ``RECORD-DIFF: FAIL``.  Exit code: 0; 1 on a divergence; 2 when
a leg fails (``--device cuda`` without a card fails with the CLI's error
and never runs on the CPU).  A failed leg stops the run before any
comparison unless ``--keep-going`` is given: then the legs that ran are
still compared and printed, and the exit code is 2.
"""

import argparse
from concurrent.futures import ThreadPoolExecutor
import os
import re
import subprocess
import sys
import tempfile
import time

from .. import goldens

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SUMMARY = re.compile(r"model on (\S+) (f32|f64): (\d+) requests .*"
                     r"kernel launches: ([^;]*);")


class LegFailed(RuntimeError):
    pass


def _run_leg(bam, fa, out, device, regime, timeout):
    """(wall s, return code, stderr) of one uvc1 process."""
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "uvc_tpu_torch.cli.uvc1", "-f", fa, "-o", out,
         "-t", "1", bam, "--device", device, "--model-regime", regime],
        env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        timeout=timeout)
    return time.time() - t0, r.returncode, r.stderr


def run(device, workdir, keep_going=False, timeout=900):
    """Build the workload in ``workdir`` and run every leg of ``device``
    side by side.  Returns {"bodies", "walls" (s), "requests", "devices",
    "launches" (each leg's kernel launch counts, from its summary line),
    "failed" (the failed legs' messages), "records" (of the golden body),
    "divergences" (the device leg against the golden one, f32 contract),
    "f64_divergences" (the card's f64 body against the golden body, byte
    for byte; [] off the card)}.  Raises LegFailed when a leg fails,
    unless ``keep_going``."""
    bam, fa = goldens.build_f32_parity_input(workdir)
    plan = [("golden", "cpu", "f64"), ("device", device, "f32")]
    if device == "cuda":
        plan.append(("device_f64", "cuda", "f64"))
    outs = {leg: os.path.join(workdir, f"{leg}.vcf.gz") for leg, _, _ in plan}
    with ThreadPoolExecutor(len(plan)) as pool:
        futs = {leg: pool.submit(_run_leg, bam, fa, outs[leg], dev, regime,
                                 timeout) for leg, dev, regime in plan}
    res = {k: {} for k in ("bodies", "walls", "requests", "devices",
                           "launches")}
    res["failed"] = []
    for leg, fut in futs.items():
        wall, rc, err = fut.result()
        res["walls"][leg] = wall
        m = SUMMARY.search(err) if rc == 0 else None
        if m is None:
            res["failed"].append(f"{leg} leg returned {rc}:\n{err[-3000:]}")
            continue
        res["bodies"][leg] = goldens.read_body(outs[leg])
        res["devices"][leg] = m[1]
        res["requests"][leg] = int(m[3])
        res["launches"][leg] = {k: int(v) for k, v in (
            kv.split("=") for kv in m[4].split())}
    if res["failed"] and not keep_going:
        raise LegFailed("\n".join(res["failed"]))
    bodies = res["bodies"]
    want = bodies.get("golden")
    res["records"] = sum(not l.startswith("#") for l in want or [])
    res["divergences"] = (goldens.record_diff(bodies["device"], want)
                          if want and "device" in bodies else [])
    res["f64_divergences"] = (goldens.compare(bodies["device_f64"], want,
                                              "f64")[1]
                              if want and "device_f64" in bodies else [])
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--keep-going", action="store_true",
                    help="where a leg fails, still compare the legs that ran")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="uvc_record_diff_") as d:
        try:
            res = run(args.device, d, keep_going=args.keep_going)
        except LegFailed as e:
            print(f"RECORD-DIFF: a leg failed:\n{e}", file=sys.stderr)
            return 2
    errs = res["divergences"] + [f"cuda f64 body: {e}"
                                 for e in res["f64_divergences"]]
    walls = ", ".join(f"{k} {v:.2f} s" for k, v in res["walls"].items())
    for e in errs[:40]:
        print("  " + e)
    for e in res["failed"]:
        print(f"RECORD-DIFF: {e}", file=sys.stderr)
    if errs or res["failed"]:
        print(f"RECORD-DIFF: FAIL ({len(errs)} divergences over "
              f"{res['records']} records, {len(res['failed'])} failed legs;"
              f" {walls})")
        return 2 if res["failed"] else 1
    print(f"RECORD-DIFF: OK ({res['records']} records: the {args.device} "
          f"f32 body within the f32 contract of the cpu f64 body"
          + (", the cuda f64 body byte-identical" if args.device == "cuda"
             else "") + f"; {walls})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
