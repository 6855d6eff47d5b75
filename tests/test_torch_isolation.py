"""The port stands alone: nothing under src/repro_torch imports jax or the
reference package, and every port module imports with jax unavailable."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the test process has both; the port must not need it)
import torch  # noqa: F401

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield path, ".".join(parts)


def test_no_jax_or_reference_imports():
    offenders = []
    for path, _ in _port_modules():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if FORBIDDEN.match(line):
                offenders.append(f"{path.relative_to(PORT.parent)}:{n}: {line.strip()}")
    assert not offenders, "\n".join(offenders)
    assert len(list(_port_modules())) >= 15


def test_every_module_imports_without_jax():
    names = [name for _, name in _port_modules()]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=PORT.parents[1], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(PORT.parent)}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
