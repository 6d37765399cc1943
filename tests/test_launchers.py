"""The launchers' contracts that hold without a card: the compile-cache
location, and chip_smoke.py refusing to run (and printing no result)
when JAX finds no GPU."""

import json
import os
import sys

import jax
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("from_env", [True, False])
def test_compile_cache_location(tmp_path, monkeypatch, from_env):
    from optrace_tpu.utils.compile_cache import enable_compile_cache
    was = jax.config.jax_compilation_cache_dir
    env = tmp_path / "from_env"
    if from_env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(env))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache(str(tmp_path))
        want = str(env) if from_env else str(tmp_path / ".jax_cache")
        assert path == want and os.path.isdir(want)
        if not from_env:
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", was)


@pytest.mark.parametrize("argv", [[], ["--devices", "4"]])
def test_chip_smoke_refuses_without_gpu(argv, capsys):
    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is present")
    sys.path.insert(0, ROOT)
    import chip_smoke
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert not any(line.lstrip().startswith("{") for line in out.splitlines())
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.strip().splitlines()[-1] if out.strip() else "")
