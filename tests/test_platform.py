"""The entry points' accelerator check, compile-cache rule and imports."""

import os
import subprocess
import sys

import pytest

from gnn_track_finding.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert platform.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_cpu_allowed_only_when_explicit(monkeypatch):
    # this process computes on the CPU (tests pin JAX_PLATFORMS=cpu)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert platform.require_gpu() == "cpu"
    with pytest.raises(RuntimeError, match="no GPU found"):
        platform.require_gpu(allow_explicit_cpu=False)
    monkeypatch.setenv("JAX_PLATFORMS", "")
    with pytest.raises(RuntimeError, match="no GPU found"):
        platform.require_gpu()


def _run(code: str, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("entry", [
    "gnn_track_finding.run", "bench", "chip_smoke"])
def test_entry_points_refuse_a_machine_without_gpu(entry):
    """No GPU and no explicit JAX_PLATFORMS=cpu: exit non-zero, with a
    message, before any work (chip_smoke refuses the CPU even when asked)."""
    env = {"JAX_PLATFORMS": "" if entry != "chip_smoke" else "cpu",
           "CUDA_VISIBLE_DEVICES": ""}
    code = (f"import runpy, sys; sys.argv = ['{entry}']; "
            f"runpy.run_module('{entry}', run_name='__main__')")
    done = _run(code, env)
    assert done.returncode != 0
    assert "no GPU found" in done.stderr
    assert '"ok"' not in done.stdout


def test_main_path_imports_without_flax_and_pandas():
    """The main path needs neither flax nor pandas (pandas only parses
    user CSVs): import it with both blocked and run a volume-7 load."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('flax', 'pandas'):
            raise ImportError('blocked ' + name)
sys.meta_path.insert(0, Block())
from gnn_track_finding.config import PipelineConfig
from gnn_track_finding.data import prefetch, trackml
from gnn_track_finding.models import pipeline
from gnn_track_finding.parallel import edge_shard, mesh
from gnn_track_finding.evaluation import efficiency
import chip_smoke, bench
g, _ = trackml.load_event('trackml_v7', PipelineConfig(), with_tracker=False)
assert 'flax' not in sys.modules and 'pandas' not in sys.modules
print('ok', g.n_nodes)
"""
    done = _run(code, {"JAX_PLATFORMS": "cpu"})
    assert done.returncode == 0, done.stderr
    assert "ok 8748" in done.stdout


def test_device_report_names_the_device_and_cache():
    """One line with the JAX version, platform, kind, count and cache dir;
    the nvidia-smi line is added only on a GPU."""
    import jax

    lines = platform.device_report("/cache")
    assert len(lines) == 1
    assert lines[0].startswith(f"jax {jax.__version__} platform=cpu ")
    assert "count=" in lines[0] and lines[0].endswith("compile_cache=/cache")
