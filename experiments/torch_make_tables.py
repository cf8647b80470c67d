"""The dry-run and roofline tables of the PyTorch port, from the records
``repro_torch.launch.dryrun`` writes to ``experiments/dryrun_torch/*.json``
— the twin of ``make_tables.py``, in its arch and shape order.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  python experiments/torch_make_tables.py [--mesh 16x16] [--tag '']
      [--compare TAG]

The port's records count what a rank stores (the train state, or the
served tree and the decode caches by the reference's ``cache_shardings``),
the model FLOPs and every bulk collective of a step from the port's own
plans, and what one rank's step executed on fake tensors: the live
bytes' high-water mark (``memory_analysis``) and the executed FLOPs and
HBM bytes (``op_analysis``); the roofline divides the executed work by
the H100 SXM datasheet's figures.  The reference's columns mem/dev GiB
(the peak a rank), executed TFLOP/dev (its HLO TFLOP/dev) and the useful
fraction read those fields; a record that was not executed (2x16x16:
the port's run-time mesh has no pod axis) shows "not executed" there.
:func:`compare` sets each pair's bound in the records tagged ``TAG``
beside the untagged ones'.
"""
import argparse
import glob
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
DIR = os.path.join(HERE, "dryrun_torch")

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = ["rwkv6-1.6b", "h2o-danube-3-4b", "yi-6b",
              "llama4-maverick-400b-a17b", "dbrx-132b", "internvl2-2b",
              "zamba2-7b", "gemma2-9b", "hubert-xlarge", "starcoder2-3b"]
STORED = ("params", "opt", "batch", "caches", "total")


def load(mesh: str, tag: str = ""):
    """Each ``(arch, shape)``'s record in ``DIR`` at ``mesh`` (and
    ``tag``)."""
    recs = {}
    for f in glob.glob(os.path.join(DIR, "*.json")):
        parts = os.path.basename(f)[:-5].split("__")
        if len(parts) != (4 if tag else 3) or parts[2] != mesh:
            continue
        if tag and parts[3] != tag:
            continue
        with open(f) as fh:
            recs[(parts[0], parts[1])] = json.load(fh)
    return recs


def gib(b):
    return f"{b / 2**30:.2f}"


def _rows(recs, blank: int, row):
    """One line per (arch, shape) in the reference's order: ``row(rec)``'s
    cells, MISSING or the skip reason; and the count of each."""
    lines, n_run, n_skip = [], 0, 0
    pad = " |" * blank
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            r = recs.get((a, s))
            if r is None:
                lines.append(f"| {a} | {s} | MISSING |{pad}")
            elif "skipped" in r:
                n_skip += 1
                lines.append(f"| {a} | {s} | *skip: {r['skipped']}* |{pad}")
            else:
                n_run += 1
                lines.append(f"| {a} | {s} | " + " | ".join(row(r)) + " |")
    return lines, n_run, n_skip


def dryrun_table(mesh: str, tag: str = "") -> str:
    """Stored GiB a rank (by part), model TFLOP a chip, and the bulk
    collectives of a step: their count and wire GB a rank."""
    head = ["| arch | shape | " + " | ".join(
        f"{k} GiB/rank" for k in STORED)
        + " | model TFLOP/chip | collectives | coll GB/rank |",
        "|---" * (len(STORED) + 5) + "|"]

    def row(r):
        st, co = r["stored_bytes"], r["collectives"]
        return ([gib(st[k]) if k in st else "—" for k in STORED]
                + [f"{r['model_flops_per_chip'] / 1e12:.2f}",
                   str(co["count"]), f"{co['total_wire_bytes'] / 1e9:.2f}"])
    lines, n_run, n_skip = _rows(load(mesh, tag), len(STORED) + 2, row)
    return "\n".join(head + lines + [
        f"\n{n_run} pairs counted, {n_skip} documented skips (mesh {mesh})."])


NOT_RUN = "not executed"


def roofline_table(mesh: str, tag: str = "") -> str:
    """The roofline's three terms, the dominant one and the bound, and
    the reference's executed columns: the peak a rank (mem/dev GiB), the
    executed TFLOP a rank and the useful fraction."""
    head = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | bound s | mem/dev GiB | executed TFLOP/dev | "
            "useful frac |", "|---" * 10 + "|"]

    def row(r):
        ro = r["roofline"]
        ma, oa = r.get("memory_analysis"), r.get("op_analysis")
        return [f"{ro['compute_s']:.2e}", f"{ro['memory_s']:.2e}",
                f"{ro['collective_s']:.2e}",
                f"**{ro['dominant'].replace('_s', '')}**",
                f"{ro['step_time_bound_s']:.2e}",
                NOT_RUN if ma is None else gib(ma["peak_per_device_bytes"]),
                NOT_RUN if oa is None else f"{oa['flops'] / 1e12:.2f}",
                NOT_RUN if oa is None
                else f"{min(ro['useful_fraction'], 9.99):.2f}"]
    lines, n_run, n_skip = _rows(load(mesh, tag), 7, row)
    return "\n".join(head + lines + [
        f"\n{n_run} pairs, {n_skip} documented skips (mesh {mesh}; the "
        f"H100 SXM datasheet's constants, not measurements)."])


def compare(mesh: str = "16x16", tag: str = "baseline") -> str:
    """Each pair's step-time bound in the records tagged ``tag`` beside
    the untagged records' (dominant term in brackets), and their ratio;
    pairs missing or skipped on either side are left out."""
    base, new = load(mesh, tag), load(mesh)
    lines = [f"| arch | shape | {tag} bound s (dom) | bound s (dom) | "
             f"speedup |", "|---|---|---|---|---|"]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            b, o = base.get((a, s)), new.get((a, s))
            if not b or not o or "skipped" in b or "skipped" in o:
                continue
            rb, ro = b["roofline"], o["roofline"]
            sp = rb["step_time_bound_s"] / max(ro["step_time_bound_s"],
                                               1e-12)
            lines.append(
                f"| {a} | {s} | {rb['step_time_bound_s']:.2e} "
                f"({rb['dominant'].replace('_s', '')}) | "
                f"{ro['step_time_bound_s']:.2e} "
                f"({ro['dominant'].replace('_s', '')}) | {sp:.2f}× |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    ap.add_argument("--compare", default=None, metavar="TAG",
                    help="also set each pair's bound in the records tagged "
                         "TAG beside the untagged ones'")
    args = ap.parse_args(argv)
    print(dryrun_table(args.mesh, args.tag))
    print()
    print(roofline_table(args.mesh, args.tag))
    if args.compare:
        print()
        print(compare(args.mesh, args.compare))


if __name__ == "__main__":
    main()
