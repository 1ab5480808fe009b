"""The port's dry-run records as a Markdown table, one row per cell.

Reads the JSON files that ``python -m repro_torch.launch.dryrun`` writes
(``experiments/dryrun_torch.json`` unless paths are given; several files
are merged, a later one's key replacing an earlier one's) and prints, for
every cell, its status, ``run_s`` (the host's seconds to run the sharded
step on one rank's meta shards), the dominant roofline term, the
collective term, the temporary and peak bytes per rank and whether the
peak fits 80 GB. The terms are modeled from the H100 SXM data sheet's
peaks for the port's own sharded program
(``repro_torch.analysis.roofline``), not measurements of a card.

    python3 tools/dryrun_table_torch.py [FILE ...]
"""
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DEFAULT = os.path.join(ROOT, "experiments", "dryrun_torch.json")
GIB = 2 ** 30


def rows(records):
    """Markdown rows of the records, single-pod cells first; ``mesh`` ends
    in ``tuned`` for a cell run with the reference's hill-climb tuning."""
    out = ["| arch | shape | mesh | status | run_s | dominant | "
           "collective_s | temp GiB | peak GiB | fits 80 GB |",
           "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]

    def order(key):
        arch, shape, mesh = key.split("|")[:3]
        return mesh != "pod16x16", "|tuned" in key, arch, shape

    for key in sorted(records, key=order):
        r = records[key]
        arch, shape, *mesh = key.split("|")
        cell = f"| {arch} | {shape} | {' '.join(mesh)} |"
        if r.get("status") == "ok":
            out.append(
                f"{cell} ok | {r['run_s']} | {r['dominant']} | "
                f"{r['collective_s']:.3e} | {r['temp_bytes'] / GIB:.2f} | "
                f"{r['hbm_total_gib']:.2f} | {r['fits_hbm']} |")
        else:
            why = (r.get("error") or r.get("note") or "").replace("|", "/")
            out.append(f"{cell} {r.get('status')} | | {why[:80]} | | | | |")
    return out


def main(paths):
    records = {}
    for path in paths or [DEFAULT]:
        with open(path) as f:
            records.update(json.load(f))
    print("\n".join(rows(records)))


if __name__ == "__main__":
    main(sys.argv[1:])
