"""The port's training entry point: the loop's contract on a stand-in, and
one real run against the JAX package's train step and checkpoint loader.

The stand-in (no ResNet): a module of four linear layers named so that
the six optimizer groups are made (``backbone``, ``segment``,
``cross_att``, ``audio_backbone``), a step that draws from the state's
generator, updates both optimizers and the sound bank, and a validation
that returns a given mIoU per call. With them ``run_training`` runs in
milliseconds and shows: the validation epochs, ``best_model`` only on a
better mIoU and never under ``--ignore_ckpt``, the preemption checkpoint
and the resume from it, the global batch under ``--gpus``, ``--debug``,
and the checkpoint module's swap, alias and error rules (as
``tests/test_checkpoint.py`` holds the JAX package's).

The real run is ``cavp_tpu_torch.main_avss_resize.main(argv, device="cpu")``
on the port's synthetic tree (48x48: the avss setup with its image size
cut, as neither package has a flag for it; the setup's 71 classes, masks
of 6; 4 train and 4 test videos), float32, ``visual_backbone=18``, batch 2: two steps, the
validation at epoch 0, then a preemption at the first batch of epoch 1,
which writes the suite's one full-state checkpoint (about 1.1 GB). It is
made once per test run (``once_per_run``, about 20 s) and shares a small
report: the first step against ``make_train_step`` on the same batch from
a fresh state of the same seed (bit-equal on the CPU), the ``preempt``
file against the live state (bit-equal), and the file's ``model`` through
the JAX package's ``.pth`` loader and its exporter (nothing missing or
unexpected, bit-equal). No JAX ``run_training`` runs: its draws come from
``jax.random``; its step is held against the port's in
``test_torch_port_train_step.py``.
"""

import os
import shutil
import signal
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cavp_tpu.config import get_config as jax_get_config
from cavp_tpu.engine.checkpoint import load_model_variables as jax_load_model_variables
from cavp_tpu.engine.convert import export_torch_state_dict
from cavp_tpu.engine.runner import build_model as jax_build_model
from cavp_tpu_torch import main_avss, main_avss_resize
from cavp_tpu_torch.config import flags, load_args_and_config
from cavp_tpu_torch.config.setups import get_config
from cavp_tpu_torch.data.synthetic import make_synthetic_avss
from cavp_tpu_torch.engine import checkpoint, loops, runner
from cavp_tpu_torch.engine.optim import GROUPS, label_params, make_optimizer
from cavp_tpu_torch.engine.state import create_train_state
from cavp_tpu_torch.utils import Tensorboard
from torch_port_common import once_per_run

# ---------------------------------------------------------------------------
# the stand-in
# ---------------------------------------------------------------------------


class StandIn(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.segment = torch.nn.Linear(4, 2)
        self.cross_att = torch.nn.Linear(4, 2)
        self.audio_backbone = torch.nn.Linear(4, 2)


class Loop:
    """Stand-ins for the runner's model, step and validation, and what the
    loop handed them."""

    def __init__(self, mious=(), nan_at=None):
        self.mious = list(mious)
        self.nan_at = nan_at
        self.steps = []        # (step before, epoch, batch size)
        self.validations = []  # the epoch of each
        self.states = []

    def init_state(self, config, device, steps_per_epoch):
        model = StandIn()
        with torch.no_grad():
            g = torch.Generator().manual_seed(config.seed)
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=g))
        optimizers, _ = make_optimizer(model, config, steps_per_epoch)
        self.states.append(create_train_state(model, optimizers, config, device))
        return self.states[-1]

    def make_train_step(self, model, optimizers, config, variant="avss"):
        def step(state, batch, epoch):
            self.steps.append((state.step, epoch, batch["x"].shape[0]))
            optimizers.zero_grad()
            h = model.backbone(batch["x"] + torch.rand(batch["x"].shape,
                                                       generator=state.generator))
            loss = sum((m(h) ** 2).mean() for m in (model.segment, model.cross_att,
                                                    model.audio_backbone))
            loss.backward()
            optimizers.step(state.step)
            state.step += 1
            state.sound_bank = state.sound_bank + 1.0
            if state.step == self.nan_at:
                loss = loss * float("nan")
            return state, {"loss/loss": loss.detach(), "corocl/anchor_count": torch.tensor(3)}
        return step

    def run_validation(self, config, model, test_loader, device, wandb_=None):
        assert not model.training and wandb_ is not None and wandb_.eval_list == []
        self.validations.append(self.steps[-1][1])
        miou = self.mious.pop(0) if self.mious else 0.0
        return {"miou": miou, "acc": 0.5, "fdr": 0.1, "f_1": 0.2, "f_0.3": 0.3}


def _datasets(n_items):
    items = [{"x": np.full(3, i, np.float32), "name": f"v{i}"} for i in range(n_items)]

    def collate(batch):
        return {"x": np.stack([it["x"] for it in batch]), "name": [it["name"] for it in batch]}

    return lambda config: (items, [None], collate)


def _config(*flags_):
    return load_args_and_config(["--setup", "avss", "--batch_size", "2", "--num_workers", "1",
                                 *flags_]).replace(num_classes=3)


class TriggerAfter:
    """A preemption signal that turns on at its n-th check."""

    def __init__(self, n):
        self.n = n

    @property
    def triggered(self):
        self.n -= 1
        return self.n < 0

    def install(self):
        return self

    def uninstall(self):
        pass


@pytest.fixture
def loop(monkeypatch):
    made = Loop()
    for name in ("init_state", "make_train_step", "run_validation"):
        monkeypatch.setattr(runner, name, getattr(made, name))
    return made


def _train(loop, config, tmp_path, n_items=4, **kw):
    return runner.run_training(config, "avss", _datasets(n_items), ckpt_dir=str(tmp_path),
                               device="cpu", **kw)


def test_validation_runs_every_fifth_epoch_and_from_epoch_50(loop, tmp_path):
    state, _ = _train(loop, _config("--epochs", "53", "--ignore_ckpt"), tmp_path, n_items=2)
    assert state.step == 53 and [e for _, e, _ in loop.steps] == list(range(53))
    assert loop.validations == [*range(0, 50, 5), 50, 51, 52]


def test_best_model_is_written_on_a_better_miou_only(loop, tmp_path, monkeypatch):
    saves = []
    real = checkpoint.save_checkpoint
    monkeypatch.setattr(checkpoint, "save_checkpoint",
                        lambda path, state, extra=None, blocking=True:
                        saves.append((os.path.basename(path), state.step, extra, blocking))
                        or real(path, state, extra, blocking))
    loop.mious = [0.2, 0.1, 0.3]
    state, best = _train(loop, _config("--epochs", "11"), tmp_path)
    assert best == 0.3 and loop.validations == [0, 5, 10]
    assert [(n, s, e["epoch"], e["best_iou"], b) for n, s, e, b in saves] == [
        ("best_model.pth", 2, 0, 0.2, False), ("best_model.pth", 22, 10, 0.3, False)]
    payload = checkpoint.restore_checkpoint(str(tmp_path / "best_model.pth"))
    assert payload["step"] == 22 and payload["best_iou"] == 0.3
    assert os.path.realpath(tmp_path / "epoch-last.pth") == str(tmp_path / "best_model.pth")

    other = tmp_path / "ignored"
    loop.mious = [0.2, 0.1, 0.3]
    saves.clear()
    _, best = _train(loop, _config("--epochs", "11", "--ignore_ckpt"), other)
    assert best == 0.3 and saves == [] and os.listdir(other) == []


def test_preemption_writes_and_raises_and_the_resume_takes_up_the_run(loop, tmp_path):
    """Preempted at the second batch of epoch 1 (after 3 steps, best mIoU
    0.4 from epoch 0): the file holds the live state, and the resumed run
    restores step, state and best_iou and replays epoch 1 from its start."""
    loop.mious = [0.4]
    cfg = _config("--epochs", "4", "--ignore_ckpt")
    with pytest.raises(runner.PreemptedError, match="--ckpt_path .*preempt.pth"):
        _train(loop, cfg, tmp_path, preempt=TriggerAfter(3))
    live = loop.states[-1]
    assert live.step == 3 and [e for _, e, _ in loop.steps] == [0, 0, 1]
    path = str(tmp_path / "preempt.pth")
    payload = checkpoint.restore_checkpoint(path)
    assert (payload["step"], payload["epoch"], payload["iteration"], payload["best_iou"]) == \
        (3, 1, 2, 0.4)
    _assert_state_equals(payload, live)

    loop.steps.clear()
    state, best = _train(loop, cfg.replace(ckpt_path=path), tmp_path / "resumed")
    resumed = loop.states[-1]
    assert best == 0.4 and loop.validations == [0]  # no epoch of 1-3 validates
    assert loop.steps[0][:2] == (3, 1) and [e for _, e, _ in loop.steps] == [1, 1, 2, 2, 3, 3]
    assert state is resumed and state.step == 9


def _assert_state_equals(payload, state):
    live = {"model": state.model.state_dict(),
            "visual_optimizer": state.optimizers.sgd.state_dict(),
            "audio_optimizer": state.optimizers.adam.state_dict()}
    for part, sd in live.items():
        flat, ref = _flatten(payload[part]), _flatten(sd)
        assert sorted(flat) == sorted(ref), part
        for k in ref:
            assert type(flat[k]) is type(ref[k]), (part, k)
            if isinstance(ref[k], torch.Tensor):
                assert flat[k].dtype == ref[k].dtype and torch.equal(flat[k], ref[k]), (part, k)
            else:
                assert flat[k] == ref[k], (part, k)
    assert torch.equal(payload["sound_bank"], state.sound_bank)
    assert torch.equal(payload["generator"], state.generator.get_state())
    assert payload["step"] == state.step


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(obj, (list, tuple)) and any(isinstance(v, (dict, torch.Tensor)) for v in obj):
        out = {}
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix: obj}


def test_a_checkpoint_round_trips_bit_equal_into_a_fresh_state(loop, tmp_path):
    """Both optimizers' moments, the bank, the generator and the step: the
    restored state continues exactly as the saved one does."""
    cfg = _config("--epochs", "2", "--ignore_ckpt")
    saved, _ = _train(loop, cfg, tmp_path)
    path = checkpoint.save_checkpoint(str(tmp_path / "s.pth"), saved)
    fresh = loop.init_state(cfg, "cpu", 2)
    fresh.load_state_dict(checkpoint.restore_checkpoint(path))
    _assert_state_equals(torch.load(path, weights_only=True), fresh)
    batch = {"x": torch.ones(2, 3)}
    for state in (saved, fresh):
        state, metrics = loop.make_train_step(state.model, state.optimizers, cfg)(state, batch, 2)
    assert torch.equal(saved.model.backbone.weight, fresh.model.backbone.weight)
    assert torch.equal(saved.sound_bank, fresh.sound_bank)
    assert torch.equal(saved.generator.get_state(), fresh.generator.get_state())


def test_a_reference_pth_restores_the_weights_only(loop, tmp_path, monkeypatch):
    sd = StandIn().state_dict()
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 7}, tmp_path / "r.pth")
    cfg = _config("--epochs", "1", "--ignore_ckpt", "--ckpt_path", str(tmp_path / "r.pth"))
    monkeypatch.setattr(runner, "make_train_step",
                        lambda *a, **k: lambda state, batch, epoch:
                        loop.steps.append((state.step, epoch, 2))
                        or (state, {"loss/loss": torch.tensor(0.0)}))
    state, _ = _train(loop, cfg, tmp_path)
    assert state.step == 0  # starts at epoch 0, the step and the optimizers untouched
    for k, v in sd.items():
        assert torch.equal(state.model.state_dict()[k], v), k


def test_gpus_2_trains_a_global_batch_of_2b_on_one_device(loop, tmp_path):
    cfg = _config("--epochs", "1", "--gpus", "2", "--ignore_ckpt")
    assert cfg.lr == 2 * get_config("avss").lr  # lr *= gpus
    state, _ = _train(loop, cfg, tmp_path, n_items=9)
    assert [b for _, _, b in loop.steps] == [4, 4]  # 9 items: two global batches of 2 x 2
    assert state.sound_bank.shape[1] == 4  # the bank as deep as the global batch


def test_debug_raises_at_the_first_non_finite_loss(loop, tmp_path):
    loop.nan_at = 3
    state, _ = _train(loop, _config("--epochs", "3", "--ignore_ckpt"), tmp_path)
    assert state.step == 6  # without --debug the loop runs on
    loop.states.clear()
    with pytest.raises(FloatingPointError, match="step 3"):
        _train(loop, _config("--epochs", "3", "--ignore_ckpt", "--debug"), tmp_path)
    assert loop.states[-1].step == 4  # read one step late: no wait on the step just dispatched


def test_metrics_are_logged_with_their_step_and_lrs(loop, tmp_path, monkeypatch):
    logs = []
    monkeypatch.setattr(Tensorboard, "upload_metrics",
                        lambda self, m, step=None: logs.append((step, dict(m))))
    _train(loop, _config("--epochs", "2", "--ignore_ckpt"), tmp_path)
    steps = [(s, m) for s, m in logs if "loss/loss" in m]
    assert [s for s, _ in steps] == [1, 2, 3, 4]
    sched = loop.states[-1].optimizers.schedule
    for s, m in steps:
        assert m["lr/lr_bkb"] == sched(s) and m["corocl/anchor_count"] == 3.0
    assert [s for s, m in logs if "miou" in m] == [2]  # epoch 0's validation


def test_profile_dir_traces_steps_10_to_15_of_the_first_epoch(loop, tmp_path):
    _train(loop, _config("--epochs", "2", "--ignore_ckpt"), tmp_path / "ck", n_items=40,
           profile_dir=str(tmp_path / "trace"))
    trace = (tmp_path / "trace" / "train_steps.json").read_text()
    assert len(loop.steps) == 40 and '"name"' in trace


def test_preemption_signal_sets_its_flag_and_a_second_ctrl_c_aborts():
    before = signal.getsignal(signal.SIGINT)
    p = runner.PreemptionSignal().install()
    try:
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is signal.getsignal(signal.SIGINT) and not p.triggered
        handler(signal.SIGTERM, None)
        assert p.triggered
        with pytest.raises(KeyboardInterrupt):
            handler(signal.SIGINT, None)
        assert signal.getsignal(signal.SIGINT) is before  # restored by the abort
    finally:
        p.uninstall()


# ---------------------------------------------------------------------------
# the checkpoint module's rules
# ---------------------------------------------------------------------------


class _Payload:
    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step, "w": torch.full((3,), float(self.step))}


def test_the_swap_keeps_the_last_good_file_when_a_write_dies(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.pth")
    checkpoint.save_checkpoint(path, _Payload(1))

    def dying_save(obj, f):
        open(f, "wb").write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, _Payload(2))
    assert checkpoint.restore_checkpoint(path)["step"] == 1


def test_a_failed_async_write_surfaces_at_the_next_wait_and_not_in_a_restore(tmp_path,
                                                                            monkeypatch):
    good = checkpoint.save_checkpoint(str(tmp_path / "good.pth"), _Payload(1))
    real = torch.save
    monkeypatch.setattr(torch, "save", lambda obj, f: (_ for _ in ()).throw(OSError("gone")))
    checkpoint.save_checkpoint(str(tmp_path / "bad.pth"), _Payload(2), blocking=False)
    assert checkpoint.restore_checkpoint(good)["step"] == 1  # the stale error is not raised
    monkeypatch.setattr(torch, "save", real)
    with pytest.raises(OSError, match="gone"):  # ... but the next save raises it
        checkpoint.save_checkpoint(str(tmp_path / "next.pth"), _Payload(3))
    checkpoint.save_checkpoint(str(tmp_path / "next.pth"), _Payload(3), blocking=False)
    checkpoint.wait_for_saves()
    assert checkpoint.restore_checkpoint(str(tmp_path / "next.pth"))["step"] == 3
    assert not os.path.exists(tmp_path / "bad.pth")


def test_epoch_last_follows_the_latest_save(tmp_path):
    for name, step in (("best_model", 1), ("preempt", 2)):
        checkpoint.save_and_link_checkpoint(str(tmp_path), name, _Payload(step))
        link = tmp_path / "epoch-last.pth"
        assert os.path.islink(link) and os.path.realpath(link) == str(tmp_path / f"{name}.pth")
        assert checkpoint.restore_checkpoint(str(link))["step"] == step


def test_orbax_directories_and_other_processes_raise(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="orbax"):
        checkpoint.restore_checkpoint(str(tmp_path))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        runner.run_training(_config(), "avss", _datasets(2), device="cpu")


def test_run_validation_takes_the_runs_logger(monkeypatch):
    monkeypatch.setattr(runner, "make_eval_step", lambda model, config: lambda m, b: m)
    config = _config()
    res = runner.run_validation(config, None, [], "cpu", wandb_=Tensorboard(config))
    assert sorted(res) == sorted(["miou", "acc", "fdr", "f_1", "f_0.3", "miou_ms", "acc_ms",
                                  "fdr_ms", "f_1_ms", "f_0.3_ms"])


@pytest.mark.parametrize("entry", [main_avss_resize, main_avss], ids=["resize", "512"])
def test_entry_points_ask_for_the_card_by_default(entry, tmp_path):
    assert not torch.cuda.is_available()  # the CPU test machine
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.main(["--setup", "avss", "--root_dataset_dir", str(tmp_path)])


def test_main_avss_is_the_resize_entry_point():
    """``python -m cavp_tpu_torch.main_avss`` runs the one engine and
    command line of ``main_avss_resize``."""
    assert main_avss.main is main_avss_resize.main


# ---------------------------------------------------------------------------
# one real run
# ---------------------------------------------------------------------------

SIZE = 48
ARGV = ["--setup", "avss", "--resize_flag", "--visual_backbone", "18", "--compute_dtype",
        "float32", "--batch_size", "2", "--epochs", "2", "--num_workers", "1", "--max_view", "8",
        "--class_slots", "2", "--ignore_ckpt"]


def _real_run():
    root = tempfile.mkdtemp(prefix="torch_port_training_")
    real = dict(get_config=flags.get_config, init_state=runner.init_state,
                make_train_step=runner.make_train_step, signal=runner.PreemptionSignal)
    seen = {}

    def init_state(*a, **kw):
        seen["state"] = real["init_state"](*a, **kw)
        return seen["state"]

    def make_train_step(*a, **kw):
        step = real["make_train_step"](*a, **kw)

        def first_recorded(state, batch, epoch):
            if "batch" not in seen:
                seen["batch"] = {k: v.clone() for k, v in batch.items()}
                state, metrics = step(state, batch, epoch)
                seen["metrics"] = {k: v.clone() for k, v in metrics.items()}
                seen["params"] = [p.clone() for p in state.model.parameters()][:8]
                return state, metrics
            return step(state, batch, epoch)
        return first_recorded

    try:
        make_synthetic_avss(root, num_videos=4, image_size=SIZE, num_classes=6)
        flags.get_config = lambda setup: real["get_config"](setup).replace(
            image_width=SIZE, image_height=SIZE)
        runner.init_state, runner.make_train_step = init_state, make_train_step
        runner.PreemptionSignal = lambda: TriggerAfter(2)
        cwd = os.getcwd()
        os.chdir(root)  # ./checkpoints lands in the tree's directory
        try:
            main_avss_resize.main(ARGV + ["--root_dataset_dir", root], device="cpu")
            raise AssertionError("the run was not preempted")
        except runner.PreemptedError as exc:
            message = str(exc)
        finally:
            os.chdir(cwd)
            flags.get_config = real["get_config"]
            runner.init_state, runner.make_train_step = real["init_state"], real["make_train_step"]
            runner.PreemptionSignal = real["signal"]
        path = os.path.join(root, "checkpoints", "preempt.pth")
        report = {"message": message, "files": sorted(os.listdir(os.path.dirname(path))),
                  "size": os.path.getsize(path)}

        # the preempt file against the live state, bit for bit
        payload = checkpoint.restore_checkpoint(path)
        live = seen.pop("state")
        try:
            _assert_state_equals(payload, live)
            report["state_equal"] = True
        except AssertionError as exc:
            report["state_equal"] = repr(exc)
        report["counters"] = {k: payload[k] for k in ("step", "epoch", "iteration", "best_iou")}
        report["optimizer_groups"] = sorted(g["name"] for g in payload["visual_optimizer"]
                                            ["param_groups"] + payload["audio_optimizer"]
                                            ["param_groups"])
        report["with_gradient"] = sorted({label_params(live.model)[n] for n, p in
                                  live.model.named_parameters()
                                  if p.grad is not None and bool(p.grad.abs().sum() > 0)})
        cfg = load_args_and_config(ARGV).replace(image_width=SIZE, image_height=SIZE)
        del live

        # the model through the JAX package's .pth loader and exporter
        jcfg = jax_get_config("avss").replace(**{k: getattr(cfg, k) for k in (
            "image_width", "image_height", "num_classes", "visual_backbone", "compute_dtype")})
        jmodel = jax_build_model(jcfg)
        shapes = jax.eval_shape(
            lambda r: jmodel.init(r, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 96, 64, 1)),
                                  eval_mode=True), jax.random.PRNGKey(0))
        zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        params, stats, jreport = jax_load_model_variables(path, zeros["params"],
                                                          zeros["batch_stats"])
        exported = export_torch_state_dict(params, stats)
        model = payload["model"]
        report["jax"] = {"missing": jreport["missing"], "unexpected": jreport["unexpected"],
                         "exported": len(exported),
                         "weights": sum(not k.endswith("num_batches_tracked") for k in model),
                         "not_in_file": sorted(set(exported) - set(model)),
                         "unequal": sorted(k for k, v in exported.items()
                                           if k in model and not np.array_equal(
                                               np.asarray(v), model[k].numpy()))}
        del payload, model, params, stats, exported, zeros

        # the first step against make_train_step from a fresh state
        fresh = runner.init_state(cfg, "cpu", 2)
        _, metrics = loops.make_train_step(fresh.model, fresh.optimizers, cfg)(
            fresh, seen["batch"], 0)
        report["first_step"] = {
            "keys": sorted(metrics) == sorted(seen["metrics"]),
            "unequal": sorted(k for k in metrics if not torch.equal(metrics[k],
                                                                    seen["metrics"][k])),
            "params_equal": all(torch.equal(a, b) for a, b in
                                zip(list(fresh.model.parameters())[:8], seen["params"])),
            "loss": float(metrics["loss/loss"]), "ctr": float(metrics["loss/l_ctr_av"]),
            "batch": {k: tuple(v.shape) for k, v in seen["batch"].items()}}
        return report
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def real_run():
    return once_per_run("training_real_run", _real_run)


def test_real_run_preempts_with_a_resumable_checkpoint(real_run):
    assert real_run["files"] == ["epoch-last.pth", "preempt.pth"]  # --ignore_ckpt: no best_model
    # the counters of the last step taken, epoch 0's second
    assert real_run["counters"] == {"step": 2, "epoch": 0, "iteration": 1,
                                    "best_iou": real_run["counters"]["best_iou"]}
    assert "--ckpt_path" in real_run["message"] and "preempt.pth" in real_run["message"]
    assert real_run["state_equal"] is True, real_run["state_equal"]
    assert real_run["optimizer_groups"] == sorted(GROUPS)
    assert real_run["with_gradient"] == sorted(GROUPS)
    assert 0.9e9 < real_run["size"] < 1.3e9  # 104.4 M parameters with their moments


def test_real_run_first_step_equals_make_train_step(real_run):
    first = real_run["first_step"]
    assert first["keys"] and first["unequal"] == [] and first["params_equal"]
    assert np.isfinite(first["loss"]) and first["ctr"] > 0
    assert first["batch"] == {"image": (2, SIZE, SIZE, 3), "waveform": (2, 1, 16000),
                              "pix_label": (2, SIZE, SIZE), "img_label": (2, 71)}


def test_real_run_checkpoint_loads_into_the_jax_package(real_run):
    jr = real_run["jax"]
    assert jr["missing"] == [] and jr["unexpected"] == []
    # every weight of the file, and nothing else, comes back under its name
    assert jr["exported"] == jr["weights"] > 200
    assert jr["not_in_file"] == [] and jr["unequal"] == []
