"""Persistent compile-cache location.

JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and the package
must leave it alone; otherwise the cache lives at one fixed directory in
the checkout, which git ignores.  Each case runs in a fresh interpreter,
because the package decides at import time.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import json, jax
calls = []
_update = jax.config.update
def update(name, value):
    calls.append(name)
    return _update(name, value)
jax.config.update = update
import kaldi_ctc_tpu
print(json.dumps({"dir": jax.config.jax_compilation_cache_dir,
                  "calls": calls}))
"""


def _probe(env_dir=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=120)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_env_var_is_honoured(tmp_path):
    got = _probe(str(tmp_path / "cache"))
    assert got["dir"] == str(tmp_path / "cache")


def test_env_var_means_no_override(tmp_path):
    got = _probe(str(tmp_path / "cache"))
    assert "jax_compilation_cache_dir" not in got["calls"]


def test_default_is_fixed_dir_in_checkout():
    from kaldi_ctc_tpu import CHECKOUT_CACHE_DIR

    got = _probe()
    assert got["dir"] == CHECKOUT_CACHE_DIR == os.path.join(REPO,
                                                            ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
