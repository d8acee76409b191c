"""One run of one cell of the port's benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

prints, as its last line, the result as one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``checks`` last: each compared number with its limit).
Needs a CUDA device; exits non-zero without printing a result where it
finds none, and where the process has loaded ``jax``, ``jaxlib``, ``flax``
or ``mvkpconv_tpu``."""

import time

T0 = time.perf_counter()

import sys  # noqa: E402


def main(argv=None) -> int:
    from portbench.harness import main as run

    return run(sys.argv[1:] if argv is None else argv, T0)


if __name__ == "__main__":
    sys.exit(main())
