"""A pytest plugin and its report: which XLA programs the CPU tests
compile, how long each compile takes, and which of them more than one
test file compiles (a compile that the persistent cache serves costs
nothing and is not logged).

Run the port's tests with the plugin, each worker logging to its own
file under COMPILE_LOG_DIR (default: the working directory), then read
the logs:

    COMPILE_LOG_DIR=out PYTHONPATH=tools python -m pytest \\
        tests/test_torch_*.py -p compile_log -n 6 --dist loadfile
    python3 tools/compile_log.py out
"""

import collections
import glob
import hashlib
import json
import os
import sys
import time

import pytest

_current = {"test": None}


def pytest_configure(config):
    from jax._src import compiler
    backend_compile = compiler.backend_compile_and_load
    worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
    out_dir = os.environ.get("COMPILE_LOG_DIR", ".")
    os.makedirs(out_dir, exist_ok=True)
    log = open(os.path.join(out_dir, f"compile_{worker}.jsonl"), "a")

    def logged(backend, module, *args, **kwargs):
        t0 = time.perf_counter()
        out = backend_compile(backend, module, *args, **kwargs)
        seconds = time.perf_counter() - t0
        text = module.operation.get_asm(enable_debug_info=False)
        log.write(json.dumps({
            "program": hashlib.sha1(text.encode()).hexdigest()[:16],
            "seconds": seconds, "test": _current["test"]}) + "\n")
        log.flush()
        return out
    compiler.backend_compile_and_load = logged


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    _current["test"] = item.nodeid


def report(out_dir):
    """Print the compiles' count and seconds, those of 0.5 s or more
    (the persistent cache's threshold), the seconds spent compiling a
    program again that another compile in the run already made, and the
    files that spend the most seconds compiling."""
    rows = [json.loads(line)
            for path in glob.glob(os.path.join(out_dir, "compile_*.jsonl"))
            for line in open(path)]
    big = [r for r in rows if r["seconds"] >= 0.5]
    print(f"{len(rows)} compiles, {sum(r['seconds'] for r in rows):.1f} s; "
          f"{len(big)} of 0.5 s or more, "
          f"{sum(r['seconds'] for r in big):.1f} s")
    by_program = collections.defaultdict(list)
    for r in rows:
        by_program[r["program"]].append(r["seconds"])
    again = sum(sum(s) - min(s) for s in by_program.values())
    again_big = sum(sum(s) - min(s) for s in by_program.values()
                    if len(s) > 1 and max(s) >= 0.5)
    print(f"compiled again: {again:.1f} s, of it {again_big:.1f} s in "
          "programs of 0.5 s or more")
    per_file = collections.Counter()
    for r in rows:
        per_file[(r["test"] or "outside a test").split("::")[0]] += \
            r["seconds"]
    for name, seconds in per_file.most_common(20):
        print(f"{seconds:8.1f} s  {name}")


if __name__ == "__main__":
    report(sys.argv[1] if len(sys.argv) > 1 else ".")
