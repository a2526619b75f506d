"""A migration inside the window: the job trains until ``preempt_at`` of
the window has passed, is preempted at the next step boundary
(``Trainer.save``), moved by ``migrate_job`` to a second site directory
(the WAN time modelled, not slept), restored by a new ``Trainer`` on the
same card, and trains on to the window's end, at least ``checked_steps``.
A failed migration counts as an attempt that failed.  A ``--trace 1`` run
profiles the whole window.

The comparison adds the arrived file's int8 codes against a plain
quantization of the saved state (``codes_diff``), the restored values
against the file's plain decoding, bit for bit (``restore_diff``), and the
first resumed steps against the reference started from that decoding
(``resume_*``): the reference follows the program's saved state there, so
the start and the codec are checked by themselves."""
import time

import torch

from perfbench import bench, codec

TRACE_WINDOW = True


def prepare(run):
    """The codec's kernels, once."""
    from repro_torch.kernels import ops

    ops.dequantize_int8(*ops.quantize_int8(torch.ones(256, device=run.dev)))


def _move(run, trainer):
    """``migrate_job`` and the restore at the second site: the new trainer."""
    from repro_torch.core.migration import migrate_job

    mix, host = run.cell.mix, run.host
    with bench._range("perfbench.migrate", run.traced):
        tm = time.perf_counter()
        dst, report = migrate_job(trainer.ckpt, str(run.work / "site_b"),
                                  bandwidth_bps=mix["bandwidth_bps"], realtime=False)
        host["migrate_s"] = time.perf_counter() - tm
    live = bench.make_trainer(run.cell, run.model, run.data, "", run.dev, bench.Control(), ckpt=dst)
    with bench._range("perfbench.restore", run.traced):
        tr = time.perf_counter()
        live.restore()
        bench._sync(run.dev)
        host["restore_s"] = time.perf_counter() - tr
    host.update(migrate_nbytes=report.nbytes, migrate_t_serialize_s=report.t_serialize_s,
                migrate_t_transfer_modelled_s=report.t_transfer_s)
    run.held["restored"] = live.state_tree()
    run.held["resume_step"] = live.step
    return live


def _hold(run, live, n: int):
    """What the comparison reads of the first ``n`` resumed steps."""
    if n == 1:
        run.held["m1"] = live.opt_state["m"]
    if n == run.cell.mix["checked_steps"]:
        run.held["master3"] = live.opt_state["master"]


def window(run, t0: float, deadline: float):
    trainer, mix = run.trainer, run.cell.mix
    step0 = trainer.step
    run.control.preempt_at = t0 + mix["preempt_at"] * (deadline - t0)
    while trainer.run(max_steps=1)["status"] != "preempted":
        pass
    run.control.preempt_at = None
    run.hist = trainer.history[len(trainer.history) - (trainer.step - step0):]
    run.host["save_s"] = trainer.saves[-1].wall_time_s
    run.host["ckpt_bytes"] = trainer.saves[-1].nbytes
    run.attempted += 1
    try:
        live = _move(run, trainer)
    except Exception as err:  # a migration that raises has failed
        run.failed += 1
        bench._log(f"[migrate] failed: {err!r}")
        run.live = None
        return
    n = 0
    while True:
        live.run(max_steps=1)
        n += 1
        _hold(run, live, n)
        if time.perf_counter() >= deadline and n >= mix["checked_steps"]:
            break
    bench._sync(run.dev)
    run.hist = run.hist + live.history[-n:]
    run.live = live


def after_first(run):
    """What ``controls.py`` drives in place of the window: ``controls_steps``
    more steps, the preemption, the migration and ``checked_steps``
    resumed steps."""
    trainer, mix = run.trainer, run.cell.mix
    for _ in range(mix["controls_steps"]):
        trainer.run(max_steps=1)
    run.control.preempt_at = 0.0
    trainer.run(max_steps=1)
    run.control.preempt_at = None
    live = run.live = _move(run, trainer)
    for n in range(1, mix["checked_steps"] + 1):
        live.run(max_steps=1)
        _hold(run, live, n)


def readings(run, readings: dict) -> list:
    """``codes_diff`` and ``restore_diff`` into ``readings``; the resumed
    steps for the reference to follow."""
    held, mix, dev = run.held, run.cell.mix, run.dev
    if "restored" not in held:
        return []
    manifest, payload = codec.read(run.live.ckpt.latest.path)
    entries = codec.leaves(manifest, payload)
    run.notes["entries"] = entries
    run.notes["int8_leaves"] = [e["q_raw"] for e in entries.values() if e["enc"] == "int8"]
    src = {"/".join(p): t for p, t in bench.leaves(run.trainer.state_tree()).items()}
    readings["codes_diff"] = float(codes_diff(entries, src, codec.quantize))
    rest = {"/".join(p): t for p, t in bench.leaves(held["restored"]).items()}
    readings["restore_diff"] = float(restore_diff(entries, rest, dev))
    r_opt = held["restored"]["opt"]
    n = mix["checked_steps"]
    prog = {"losses": [h["loss"] for h in run.live.history[:n]],
            "grad": bench.grad_norms_from_m(held["m1"], r_opt["m"], mix["b1"]),
            "change": bench.diff_norms(held["master3"], r_opt["master"])}
    step = held["resume_step"]
    return [bench.Stretch("resume_", prog, lambda: decoded_state(entries, dev), range(step, step + n))]


def control_readings(run) -> dict:
    """The control's ``codes_diff``: the file's decoding quantized on 7
    levels against its int8 codes."""
    entries = run.notes["entries"]
    src = {p: codec.decode(e, run.dev) for p, e in entries.items() if e["enc"] == "int8"}
    return {"codes_diff": float(codes_diff(entries, src, codec.quantize_int4))}


def codes_diff(entries: dict, src: dict, quantize) -> int:
    """int8 codes and scales in the file that differ from ``quantize`` of the
    state that was saved."""
    bad = 0
    for path, e in entries.items():
        if e["enc"] != "int8":
            continue
        q, s = quantize(src[path])
        codes = torch.from_numpy(e["codes"].copy()).to(q.device)
        scales = torch.from_numpy(e["scales"].copy()).to(s.device)
        if codes.shape != q.shape or scales.shape != s.shape:
            bad += max(codes.numel(), q.numel())
            continue
        bad += int((codes != q).sum()) + int((scales != s).sum())
    return bad


def restore_diff(entries: dict, restored: dict, dev) -> int:
    """Restored values that differ, bit for bit, from the file's decoding."""
    bad = 0
    for path, e in entries.items():
        got = restored[path]
        want = codec.decode(e, dev)
        if not isinstance(got, torch.Tensor):
            bad += int(int(got) != int(want))
            continue
        if got.shape != want.shape or got.dtype != want.dtype:
            bad += want.numel()
            continue
        bad += int((got.reshape(-1).view(torch.uint8) != want.reshape(-1).view(torch.uint8)).sum())
    return bad


def decoded_state(entries: dict, dev) -> dict:
    """The reference's optimizer state from the file's decoding."""
    st = {"master": {}, "m": {}, "v": {}, "step": 0}
    for path, e in entries.items():
        parts = tuple(path.split("/"))
        if parts[0] == "opt" and parts[1] in ("master", "m", "v"):
            st[parts[1]][parts[2:]] = codec.decode(e, dev).float()
        elif parts == ("opt", "step"):
            st["step"] = int(codec.decode(e, "cpu"))
    return st
