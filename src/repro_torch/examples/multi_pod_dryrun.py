"""Dry-run one (arch × shape) cell on the 512-rank multi-pod production
mesh and print its memory/cost/roofline analysis, the port of the
reference's ``examples/multi_pod_dryrun.py``. The port's dry run counts a
DTensor program over ``meta`` tensors on a fake process group
(``repro_torch.launch.dryrun``), so it needs no subprocess and computes
on the host alone; ``--device`` is checked as every entry point's is.

Run:  PYTHONPATH=src python -m repro_torch.examples.multi_pod_dryrun [arch] [shape]
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import dryrun


def multi_pod_dryrun(arch: str = "granite-3-8b",
                     shape: str = "train_4k") -> list[dict]:
    """The cell on the multi-pod mesh: ``dryrun.main``'s records."""
    return dryrun.main(["--arch", arch, "--shape", shape, "--multi-pod"])


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="granite-3-8b")
    ap.add_argument("shape", nargs="?", default="train_4k")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    return multi_pod_dryrun(args.arch, args.shape)


if __name__ == "__main__":
    main()
