"""The dry-run and roofline tables of the PyTorch port, from the records
``repro_torch.launch.dryrun`` writes to ``experiments/dryrun_torch/*.json``
— the twin of ``make_tables.py``, in its arch and shape order.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  python experiments/torch_make_tables.py [--mesh 16x16] [--tag '']

The port's records count what a rank stores (the train state, or the
served tree and the decode caches by the reference's ``cache_shardings``),
the model FLOPs and every bulk collective of a step from the port's own
plans; the roofline divides them by the H100 SXM datasheet's figures.
There is no compiled program, so the reference's XLA columns (the peak
per device, the HLO FLOPs, the useful fraction) have no counterpart
here.
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


def roofline_table(mesh: str, tag: str = "") -> str:
    """The roofline's three terms, the dominant one and the bound."""
    head = ["| arch | shape | compute s | memory s | collective s | "
            "dominant | bound s |", "|---|---|---|---|---|---|---|"]

    def row(r):
        ro = r["roofline"]
        return [f"{ro['compute_s']:.2e}", f"{ro['memory_s']:.2e}",
                f"{ro['collective_s']:.2e}",
                f"**{ro['dominant'].replace('_s', '')}**",
                f"{ro['step_time_bound_s']:.2e}"]
    lines, n_run, n_skip = _rows(load(mesh, tag), 4, row)
    return "\n".join(head + lines + [
        f"\n{n_run} pairs, {n_skip} documented skips (mesh {mesh}; the "
        f"H100 SXM datasheet's constants, not measurements)."])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    print(dryrun_table(args.mesh, args.tag))
    print()
    print(roofline_table(args.mesh, args.tag))


if __name__ == "__main__":
    main()
