"""Shared set-up for the ``tests/test_torch_port_*.py`` parity tests.

One model, two packages: the port's ``CAVP`` is built from a seed, its
BatchNorm statistics and LayerNorm affines are moved off identity, and
the JAX package's variables are filled from its state dict through the
JAX package's own importer (``cavp_tpu.engine.convert``). Both then hold
the same weights, under the reference's names.

The suite runs under pytest-xdist with ``--dist load``, which spreads the
tests of one file over the workers, so a module-scoped fixture is set up
on every worker that receives one of its tests. :func:`once_per_run`
makes a heavy one cost once per run: the first worker to ask computes and
saves it, the others load the file. It is for results, not for models: a
model pair is half a gigabyte to a gigabyte on disk (the VGG tower alone
has 70 M parameters) and takes 4-6 s to build, so those fixtures stay per
worker.
"""

import atexit
import contextlib
import ctypes
import fcntl
import gc
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.engine.convert import import_torch_state_dict
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu_torch.config import get_config
from cavp_tpu_torch.engine.runner import build_model
from torch_ref import randomize_bn_stats


def _trim_forever(period=5.0):
    libc = ctypes.CDLL("libc.so.6")
    while True:
        time.sleep(period)
        libc.malloc_trim(0)


# Under xdist every worker's torch starts a thread for each core; six
# workers on a few cores then only contend, with each other and with the
# suite's float64 subprocesses (which inherit the limit). Two a worker.
# And every worker hands its freed heap back to the system every few
# seconds, whichever package's test freed it: glibc keeps it otherwise,
# and the JAX package's float64 drivers, 7-13 GB each and up to six at a
# time, run beside the workers (measured in one process: 2.45 GB after
# tests/test_variant_model_parity.py, 1.86 GB once trimmed; 4.32 and 3.19
# GB after tests/test_full_model_parity.py).
if "PYTEST_XDIST_WORKER" in os.environ:
    torch.set_num_threads(2)
    threading.Thread(target=_trim_forever, name="malloc_trim", daemon=True).start()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the small avss config of tests/test_pallas_fusion.py:82-84
SMALL = dict(image_width=64, image_height=64, num_classes=5,
             visual_backbone=18, compute_dtype="float32")


def configs(**overrides):
    """(port config, JAX config) with the same fields."""
    kw = dict(SMALL, **overrides)
    return get_config("avss").replace(**kw), jax_get_config("avss").replace(**kw)


def jax_variables(jax_model, state_dict, hw):
    """JAX variables holding ``state_dict``'s weights, strictly."""
    shapes = jax.eval_shape(
        lambda r: jax_model.init(r, jnp.zeros((1, hw[0], hw[1], 3)),
                                 jnp.zeros((1, 96, 64, 1)), eval_mode=True),
        jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, report = import_torch_state_dict(
        {k: v.numpy() for k, v in state_dict.items()},
        zeros["params"], zeros["batch_stats"])
    assert not report["missing"] and not report["unexpected"], report
    return {"params": params, "batch_stats": stats}


def release_memory():
    """Give back what a finished phase held: JAX's compiled functions, the
    garbage, and the freed heap (glibc keeps it otherwise). The train-step
    comparisons hold gigabytes per phase, beside five other workers and the
    suite's float64 subprocesses."""
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(scope="module", autouse=True)
def release_after_module():
    """Autouse in every port test module that imports it: when the module's
    tests are done on a worker, give the freed heap back (see
    :func:`release_memory`). Under ``--dist load`` each of the six workers
    then waits on the JAX package's float64 subprocesses with what it still
    holds, not with every heap it has grown."""
    yield
    release_memory()


def _shared_path(name):
    """Where the xdist workers of one run share ``name``: the system's
    temporary directory, under the run's id."""
    run = os.environ["PYTEST_XDIST_TESTRUNUID"]
    return Path(tempfile.gettempdir()) / f"torch_port_{run}_{name}.pt"


@contextlib.contextmanager
def _locked(path):
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        yield


def start_early(name, argv):
    """Under xdist, start ``argv + [path]`` once per run, in the
    background, to write what :func:`once_per_run` shares as ``name``;
    called when a test module is collected.

    The train step's reports take 5-9 GB for two to four minutes; made
    when its tests come up, they ran beside the JAX package's float64
    drivers (``tests/test_train_parity.py``, 7-13 GB each, up to six at a
    time), which come right after them in the run's order, and the
    machine ran out of memory. Started at collection, they are done before
    those begin. The worker that starts the job kills it
    if it is still running when the worker exits."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    path = _shared_path(name)
    started = path.with_suffix(".started")
    with open(f"{path}.lock", "w") as lock:
        try:  # held: another worker starts the job or computes the value
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            return
        if path.is_file() or started.is_file():
            return
        with open(path.with_suffix(".log"), "w") as log:
            proc = subprocess.Popen([*argv, str(path)], stdout=log, stderr=subprocess.STDOUT,
                                    cwd=REPO)
        started.write_text(str(proc.pid))
        atexit.register(lambda: proc.poll() is None and proc.kill())
        _BACKGROUND[path] = proc


_BACKGROUND = {}


def _wait_for(path, pid, timeout=1500):
    """Wait until the background job ``pid`` has written ``path``."""
    proc = _BACKGROUND.get(path)
    deadline = time.monotonic() + timeout
    while not path.is_file() and time.monotonic() < deadline:
        if proc is not None:
            if proc.poll() is not None:
                break
        else:
            try:  # started by another worker: gone or a zombie means done
                with open(f"/proc/{pid}/stat") as f:
                    if f.read().split(")")[-1].split()[0] == "Z":
                        break
            except FileNotFoundError:
                break
        time.sleep(0.25)
    if not path.is_file():
        log = path.with_suffix(".log")
        raise RuntimeError(f"the background job for {path.name} wrote nothing:\n"
                           + (log.read_text()[-3000:] if log.is_file() else ""))


def once_per_run(name, compute):
    """``compute()`` once per test run, shared by the xdist workers
    (pytest-xdist's recipe for data made once): the result is saved with
    ``torch.save`` beside the workers' temporary directories, under an
    exclusive lock, and the other workers load it; if :func:`start_early`
    started a job for ``name``, its result is waited for instead. Without
    xdist it is just ``compute()``. The value must pickle and should be
    small: numbers, names, small tensors."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    path = _shared_path(name)
    with _locked(path):
        started = path.with_suffix(".started")
        if started.is_file():
            _wait_for(path, int(started.read_text()))
        if path.is_file():
            return torch.load(path, weights_only=False)
        value = compute()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save(value, tmp)
        os.replace(tmp, path)
    return value


def model_pair(seed=0, **overrides):
    """(port model, port config, JAX model, JAX config, JAX variables)."""
    cfg, jcfg = configs(**overrides)
    model = build_model(cfg, "cpu", generator=torch.Generator().manual_seed(seed))
    randomize_bn_stats(model, seed)
    jmodel = jax_build_model(jcfg)
    jvars = jax_variables(jmodel, model.state_dict(),
                          (cfg.image_height, cfg.image_width))
    return model, cfg, jmodel, jcfg, jvars
