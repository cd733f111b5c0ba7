"""The compile-cache helper: the environment variable wins; otherwise the
cache goes to one fixed directory in the repository."""
import os

from textgcn.utils import compile_cache


def test_env_var_set_leaves_jax_config_alone(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(
        "jax.config.update", lambda *a: calls.append(a)
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_env_var_unset_uses_repo_cache_dir(monkeypatch):
    calls = []
    monkeypatch.setattr(
        "jax.config.update", lambda *a: calls.append(a)
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", got)]


def test_cli_main_enables_the_cache(monkeypatch):
    """cli.main turns the cache on before running any command."""
    from textgcn import cli

    seen = []
    monkeypatch.setattr(
        compile_cache, "enable_compile_cache", lambda: seen.append(1)
    )
    monkeypatch.setattr(cli, "cmd_clean", lambda args: 0)
    assert cli.main(["clean", "--dataset", "x"]) == 0
    assert seen == [1]
