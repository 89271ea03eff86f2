"""What runs on the card loads no JAX: the references load neither JAX nor
either package, and a run of the harness loads neither JAX nor the JAX
package.  Module names are compared by their whole top-level name, since
the port's name begins with the JAX package's."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def loaded_after(code: str) -> set[str]:
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
             "import json; print(json.dumps(sorted({m.split('.')[0] for m in list(sys.modules)})))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_references_load_neither_package_nor_jax():
    names = loaded_after("import meterbench.reference.loudness, meterbench.reference.spectrogram")
    assert not names & {"jax", "jaxlib", "flax", "openmeters_tpu", "openmeters_tpu_torch", "torch"}


def test_a_run_of_the_harness_loads_no_jax():
    code = (
        "import torch; torch.set_num_threads(2)\n"
        "from meterbench import run, served, check, trace, readings, manifest\n"
        "from meterbench.tests._cpu_cell import run_small, small_cell\n"
        "r = run_small(99, seconds=0.3)\n"
        "check.numbers(small_cell(), r, lambda k, n: served.samples(r, k, n))\n"
        "[manifest.metric_reader(m['name']) for m in small_cell().per_layer]\n"
        "assert run.forbidden_modules() == []\n"
    )
    names = loaded_after(code)
    assert "openmeters_tpu_torch" in names  # the port ran
    assert not names & {"jax", "jaxlib", "flax", "openmeters_tpu"}
