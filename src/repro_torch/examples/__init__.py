"""The reference's six ``examples/`` scripts as entry points of the port,
each run as ``python -m repro_torch.examples.<name>``: ``quickstart``,
``serve_cortex``, ``multi_region``, ``colocated_serving``, ``train_lm``
and ``multi_pod_dryrun``. Each prints the reference's lines; its
``main(argv)`` takes ``--device`` (``cuda`` by default, an error without
it; ``cpu`` for the host path) and calls a function whose arguments cut
the run (fewer requests or steps) for a test.
"""


def printer():
    """``(lines, say)``: ``say(line)`` prints ``line`` and keeps it in
    ``lines``, which an example returns for a caller to compare."""
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    return lines, say
