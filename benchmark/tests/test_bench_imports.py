"""What the benchmark loads: no module it imports (the port's included) has
the top-level name jax, jaxlib, flax or nshmc_tpu, each compared whole as
the part before the first dot (so nshmc_tpu_torch passes); and the plain
reference imports nothing of nshmc_tpu_torch."""
import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "nshmc_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, names in os.walk(os.path.join(BENCH, sub)):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def test_no_source_imports_jax():
    for path in sources():
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_reference_sources_import_no_program():
    for path in sources("reference"):
        assert "nshmc_tpu_torch" not in set(imported_tops(path)), path


def _modules_after(code):
    prog = (f"import sys; sys.path[:0] = [{BENCH!r}, {os.path.join(BENCH, 'tests')!r}, "
            f"{ROOT!r}]\n{code}\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True, env=env,
                       timeout=600, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(r.stdout.split()[-2000:])


def test_a_run_loads_no_jax():
    """A whole tiny run on the CPU, the port and the reference included."""
    tops = _modules_after("import torch, run, tiny\n"
                          "run.run_cell(tiny.cell('ffhq_ldm'), 1, 0.05, 1, torch.device('cpu'))")
    assert "nshmc_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_no_program():
    tops = _modules_after("import reference.problems, reference.unet, reference.vq, "
                          "reference.ddim, reference.pixel_hmc, reference.latent_hmc, "
                          "reference.operators.inpaint_random")
    assert "torch" in tops and "nshmc_tpu_torch" not in tops and not tops & FORBIDDEN
