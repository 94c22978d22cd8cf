"""Rebuild the stored JAX outputs of the port's parity tests (tests/torch_ref).

    python scripts/build_torch_ref.py [--clean] [TEST_FILE ...]

Runs the port's parity tests (default: every tests/test_torch_*.py) on the
CPU with RDVIO_TEST_WRITE_REF set, so that every JAX half whose stored
output is missing or keyed differently (tests/test_torch_image.py
`jax_ref`: the key covers the JAX package's sources, the versions of jax,
jaxlib and numpy, the source of the JAX half's functions and of the test
helpers they call, and the check's input arrays) runs live and its output
is written to tests/torch_ref/<name>.pkl.xz. --clean deletes the stored outputs first, so
that every JAX half runs live. Prints the size of each stored file and their
sum; tests/torch_ref must stay under 5 MB.
"""

import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "tests", "torch_ref")
LIMIT_BYTES = 5 * 1024 * 1024


def main(argv):
    files = [a for a in argv if not a.startswith("--")] or sorted(
        os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "tests",
                                                                 "test_torch_*.py")))
    if "--clean" in argv:
        for p in glob.glob(os.path.join(REF_DIR, "*.pkl.xz")):
            os.remove(p)
    env = dict(os.environ, JAX_PLATFORMS="cpu", RDVIO_TEST_WRITE_REF="1")
    rc = subprocess.call([sys.executable, "-m", "pytest", *files, "-q", "-p",
                          "no:cacheprovider"], cwd=ROOT, env=env)
    total = 0
    for p in sorted(glob.glob(os.path.join(REF_DIR, "*.pkl.xz"))):
        n = os.path.getsize(p)
        total += n
        print(f"{os.path.relpath(p, ROOT)}: {n} bytes")
    print(f"total {total} bytes (limit {LIMIT_BYTES})")
    return rc or int(total > LIMIT_BYTES)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
