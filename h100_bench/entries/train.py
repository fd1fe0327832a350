"""Training cells: ``OpenProvenceTrainer.train_one_step`` on collated rows.

Set-up makes the weights from the seed on the card and builds one trainer
(fp32 masters, bf16 compute, the configuration's optimizer). It then drives
that trainer through its first ``checked_steps`` steps, through the
window's own feed (the program's ``OpenProvenceDataCollator`` on fresh
rows, then ``train_one_step``), and keeps what the check compares: each
step's loss, each leaf's first gradient as the optimizer took it (from the
optimizer's state after step 1) and each leaf's change over the checked
steps (its norm, and the change itself, kept on the host). The same
trainer then runs the window on a pool of further rows, collated inside
the window as the runner collates them, until ``--seconds`` have passed;
a traced run profiles the steps that follow. Once the window has closed
and the trainer is freed, the plain reference (``reference/train.py``) follows the checked
steps from the same weights and rows in fp32.

With ``ranks`` > 1 in the traffic mix, this process is rank 0 of a data
mesh over that many cards (NCCL, ``tcp://localhost``); the other ranks are
spawned processes that run the same steps on their share of each global
batch, and rank 0 prints the result.
"""

from __future__ import annotations

import gc
import math
import socket
import statistics
from time import perf_counter

import numpy as np

from ..lib.harness import (BENCH, HostLoad, Profiled, Run, card, check_kernels, eprint,
                           peak_bytes, sync)
from ..lib.textgen import Traffic
from ..lib.tokenizer import PairCharTokenizer
from ..lib.weights import make_weights
from ..lib.work import Work, training_work
from ..reference import modernbert as ref_model
from ..reference import train as ref_train
from ..reference.precision import CONTROL, Precision
from .serve import port_config

# Leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone under adafactor; they are left out of the
# gradient and change comparisons.
NEGLIGIBLE_LEAF = 1e-3


def build_trainer(cfg: dict, mix: dict, seed: int, device, mesh=None):
    from open_provence_tpu_torch.train.trainer import OpenProvenceTrainer

    t = cfg["training"]
    weights = make_weights(cfg, seed, device)
    micro = int(mix["micro_batches"]) if int(mix.get("ranks", 1)) == 1 else 1
    trainer = OpenProvenceTrainer(
        port_config(cfg, int(mix["max_length"])), weights, PairCharTokenizer(),
        output_dir=BENCH / "_out" / "train", learning_rate=t["learning_rate"],
        total_steps=t["total_steps"], warmup_ratio=t["warmup_ratio"],
        lr_scheduler_type=t["lr_scheduler_type"], optim=t["optim"],
        weight_decay=t["weight_decay"], max_grad_norm=t["max_grad_norm"],
        ranking_weight=t["ranking_weight"], pruning_weight=t["pruning_weight"],
        bf16=t["bf16"], gradient_accumulation_steps=micro, seed=int(seed) % (1 << 31),
        device=device, mesh=mesh)
    del weights
    return trainer


def make_collator(mix: dict):
    from open_provence_tpu_torch.train.collator import OpenProvenceDataCollator

    rows = int(mix["pairs_per_step"]) // micro_batches(mix)
    return OpenProvenceDataCollator(
        tokenizer=PairCharTokenizer(), max_length=int(mix["max_length"]),
        scores_column="teacher_score", chunks_pos_column="context_spans",
        relevant_chunks_column="context_spans_relevance", pad_pairs_to=rows)


def micro_batches(mix: dict) -> int:
    """Micro-batches a step's rows are collated in: the mix's on one rank;
    under a data mesh one global batch, which each rank slices."""
    return int(mix["micro_batches"]) if int(mix.get("ranks", 1)) == 1 else 1


def feed(trainer, collator, mix: dict, rows: list[dict]):
    """One optimizer step through the program's collator and trainer."""
    n = micro_batches(mix)
    size = len(rows) // n
    micro = [collator(rows[k * size : (k + 1) * size]) for k in range(n)]
    return trainer.train_one_step(micro if n > 1 else micro[0], sync=False)


def first_grad_norms(trainer) -> tuple[dict[str, float], dict]:
    """Each leaf's gradient as adafactor took it at step 1, from its second
    moments after that step (decay 0 at step 1: v = g^2 + eps): its norm,
    and its profile (the root mean square of each row and each column, or
    each element of a leaf that is not factored)."""
    st = trainer.opt_state
    norms, profiles = {}, {}
    for name, p in trainer.params.items():
        if f"v/{name}" in st:
            v = st[f"v/{name}"].double()
            sq = float(v.sum()) - p.numel() * 1e-30
            profiles[name] = v.sqrt().cpu().numpy().ravel()
        else:
            d1, d0 = ref_train.factored_dims(tuple(p.shape))
            row, col = st[f"v_row/{name}"].double(), st[f"v_col/{name}"].double()
            sq = float(row.sum()) * p.shape[d0] - p.numel() * 1e-30
            profiles[name] = np.concatenate([row.sqrt().cpu().numpy().ravel(),
                                             col.sqrt().cpu().numpy().ravel()])
        norms[name] = math.sqrt(max(sq, 0.0))
    return norms, profiles


def grad_profiles(grads: dict) -> dict:
    """``first_grad_norms``'s profiles of a gradient the reference holds."""
    out = {}
    for name, g in grads.items():
        g2 = g.double() * g.double() + 1e-30
        dims = ref_train.factored_dims(tuple(g.shape))
        if dims is None:
            out[name] = g2.sqrt().cpu().numpy().ravel()
        else:
            d1, d0 = dims
            out[name] = np.concatenate([g2.mean(d0).sqrt().cpu().numpy().ravel(),
                                        g2.mean(d1).sqrt().cpu().numpy().ravel()])
    return out


def changes(params: dict, cfg: dict, seed: int, device, to_host: bool = False
            ) -> tuple[dict[str, float], dict]:
    """Each leaf's change from the seed's weights: its norm, and the change
    itself (moved to the host with ``to_host``)."""
    start = make_weights(cfg, seed, device)
    norms, deltas = {}, {}
    for k, w in start.items():
        d = params[k].detach() - w
        norms[k] = float(d.double().norm())
        deltas[k] = d.cpu() if to_host else d
    del start
    return norms, deltas


def checked_steps(trainer, collator, mix, traffic) -> dict:
    """Drive the trainer's first steps and keep what the check compares."""
    losses, ranking, grads = [], [], None
    for s in range(int(mix["checked_steps"])):
        m = feed(trainer, collator, mix, traffic.train_rows(s))
        losses.append(float(m["loss"]))
        ranking.append(float(m["ranking_loss"]))
        if s == 0:
            grads, profiles = first_grad_norms(trainer)
    return {"losses": losses, "ranking": ranking, "grads": grads, "profiles": profiles}


def _pick_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(run: Run) -> dict:
    mix = run.cell.mix
    ranks = int(mix.get("ranks", 1))
    if ranks == 1:
        return _rank(run, 0, 1, None)
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = _pick_port()
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_child, args=(run.cell, run.seed, run.seconds, run.trace,
                                                   run.device, r, ranks, port, queue))
             for r in range(1, ranks)]
    for p in procs:
        p.start()
    try:
        measured = _rank(run, 0, ranks, port)
        extra = [queue.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=120)
            if p.is_alive():
                p.kill()
                p.join()
    measured["memory_peak_bytes"] = max([measured["memory_peak_bytes"]]
                                        + [e["memory_peak_bytes"] for e in extra])
    if run.trace:
        run.rank_summaries = [run.summary] + [e["summary"] for e in extra]
    return measured


def _rank_child(cell, seed, seconds, trace, device, rank, ranks, port, queue) -> None:
    from ..lib import harness

    harness.setenv()
    run = harness.Run(cell, seed, seconds, trace, perf_counter(), device=device)
    measured = _rank(run, rank, ranks, port)
    queue.put({"memory_peak_bytes": measured["memory_peak_bytes"], "summary": run.summary})


def _rank(run: Run, rank: int, ranks: int, port) -> dict:
    import importlib

    device = card(run, rank)
    plant = run.cell.workload.get("plant")
    if plant:
        # A test's fault ("module:function"), planted in every rank.
        module, name = plant.split(":")
        getattr(importlib.import_module(module), name)()
    mesh = ctrl = None
    if ranks > 1:
        import torch.distributed as dist
        from open_provence_tpu_torch.parallel.mesh import create_mesh

        if device.type == "cuda":
            dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                    world_size=ranks, rank=rank, device_id=device)
        else:  # a CPU rehearsal
            dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                    world_size=ranks, rank=rank)
        mesh = create_mesh(data=ranks, model=1)
        # Rank 0's clock closes the window for every rank: its decision
        # goes out each step over a host (gloo) group, beside the card's.
        ctrl = dist.new_group(backend="gloo")
    try:
        return _train(run, rank, device, mesh, ctrl)
    finally:
        if ranks > 1:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(run: Run, rank: int, device, mesh, ctrl=None) -> dict:
    import torch
    from open_provence_tpu_torch import kernels

    cell, mix, cfg = run.cell, run.cell.mix, run.cell.config
    trainer = build_trainer(cfg, mix, run.seed, device, mesh)
    collator = make_collator(mix)
    traffic = Traffic(mix, run.seed)
    checked = int(mix["checked_steps"])
    got = checked_steps(trainer, collator, mix, traffic)
    # Only rank 0 checks; it keeps the changes on the host, off the card.
    got["changes"], got["deltas"] = changes(trainer.params, cfg, run.seed, device,
                                            to_host=rank == 0)
    if rank:
        got = None
    pool = [traffic.train_rows(checked + k) for k in range(int(mix["steps_in_pool"]))]
    sync(device)
    kernels.reset_launch_counts()
    gc.collect()
    gc.freeze()
    run.setup_s = perf_counter() - run.t0

    stop = torch.zeros(1, dtype=torch.int32)
    load = HostLoad()
    load.start()
    start = perf_counter()
    n = 0
    while True:
        stop[0] = int(perf_counter() - start >= run.seconds)
        if ctrl is not None:
            torch.distributed.broadcast(stop, 0, group=ctrl)
        if stop[0]:
            break
        feed(trainer, collator, mix, pool[n % len(pool)])
        n += 1
    sync(device)
    run.window_s = perf_counter() - start
    gc.unfreeze()
    if rank == 0:
        eprint(load.report())
    count = int(mix["profile"]["steps"])
    if run.trace:
        # The profiled slice: the steps that follow the window.
        profiler = Profiled(BENCH / "_out" / "traces" / f"{cell.name}.rank{rank}.json")
        profiler.start()
        for k in range(n, n + count):
            feed(trainer, collator, mix, pool[k % len(pool)])
        profiler.stop()
    run.attempted = n
    pairs = n * int(mix["pairs_per_step"])
    run.e2e = {"train_pairs_per_s": pairs / run.window_s}
    memory_peak = peak_bytes(device)
    check_kernels(run, device, kernels.DEFAULT_PATH_KERNELS)
    if rank == 0:
        eprint(f"steps in the window: {n}, pairs {pairs}, window {run.window_s:.3f} s")
    if run.trace:
        run.summary = profiler.summary()
        max_len, rows = int(mix["max_length"]), int(mix["pairs_per_step"])
        per_step = [training_work(cfg, row_lengths(r, max_len), rows // micro_batches(mix))
                    for r in pool]
        run.window_work, run.slice_work = Work(), Work()
        for k in range(n):
            run.window_work.merge(per_step[k % len(pool)])
        run.slice_units = count
    del trainer, collator
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        check(run, got, device)
    return {"memory_peak_bytes": int(memory_peak)}


def row_lengths(rows: list[dict], max_length: int) -> list[int]:
    """Valid tokens of each collated row: [CLS] query [SEP] text [SEP], cut."""
    return [min(max_length, len(r["query"]) + len(r["texts"][0]) + 3) for r in rows]


def reference_steps(cfg: dict, mix: dict, seed: int, device, prec: Precision | None = None,
                    keep_rows: float = 1.0, only_rows: int | None = None) -> dict:
    """The reference's losses, first clipped gradient norms and changes over
    the checked steps; ``keep_rows`` < 1 plants the half-batch fault (each
    micro-batch's first rows only, the mean over them), ``only_rows`` the
    missing exchange (one rank's rows under the global normalizers)."""
    import torch

    ref_model.fp32_mode()
    t = cfg["training"]
    traffic = Traffic(mix, seed)
    params = {k: v.requires_grad_() for k, v in make_weights(cfg, seed, device).items()}
    opt = ref_train.Adafactor(t["learning_rate"], t["total_steps"], t["warmup_ratio"],
                              t["max_grad_norm"])
    n_micro = int(mix["micro_batches"])
    losses, ranking, grads = [], [], None
    for s in range(int(mix["checked_steps"])):
        rows = traffic.train_rows(s)
        size = len(rows) // n_micro
        micro = [ref_train.collate(rows[k * size : k * size + int(size * keep_rows)],
                                   int(mix["max_length"])) for k in range(n_micro)]
        loss, r_loss, g = ref_train.step_loss_and_grads(params, cfg, micro, device, prec,
                                                        only_rows=only_rows)
        losses.append(loss)
        ranking.append(r_loss)
        if s == 0:
            clipped = opt.clipped(g)
            grads, profiles = ref_train.leaf_norms(clipped), grad_profiles(clipped)
            del clipped
        opt.step(params, g)
        del g
    norms, deltas = changes(params, cfg, seed, device)
    del params, opt
    return {"losses": losses, "ranking": ranking, "grads": grads, "profiles": profiles,
            "changes": norms, "deltas": deltas}


def gaps(got: dict, want: dict) -> dict:
    """The numbers: the worst step's relative loss gap and the worst gap of
    the loss's change from one step to the next, and of the ranking loss's
    (each over the mean of the reference's values); by the worst and by
    the median leaf, the gap of the first gradient's norm and of the
    change's norm, each over the larger of that leaf's reference norm and
    the median leaf's; by the median leaf, the relative distance of the
    first gradient's profiles (the root mean square of its rows and
    columns, as adafactor keeps them) and of the change itself, element by
    element: adafactor scales each update to a fixed size, so the change's
    norm barely depends on the rows a step saw, while its elements follow
    each row's share of the gradient. Leaves whose reference gradient is
    negligible are left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    # The loss's change from step to step: the forward's rounding, nearly
    # the same at every step, cancels; a step's rows left out do not.
    def step_gap(a, b):
        return max(abs((a[k + 1] - a[k]) - (b[k + 1] - b[k])) for k in range(len(b) - 1)) \
            / (sum(abs(x) for x in b) / len(b))

    step = step_gap(got["losses"], want["losses"])
    # The same of the ranking loss (mean squared error to the teacher's
    # scores), whose rows differ far more than the tokens' cross-entropy.
    ranking_step = step_gap(got["ranking"], want["ranking"])
    med_g = statistics.median(want["grads"].values())
    leaves = [k for k, v in want["grads"].items() if v >= NEGLIGIBLE_LEAF * med_g]
    out = {"loss_gap": loss, "loss_step_gap": step, "ranking_step_gap": ranking_step}
    for key in ("grads", "changes"):
        med = statistics.median(want[key][k] for k in leaves)
        per_leaf = {k: abs(got[key][k] - want[key][k]) / max(want[key][k], med) for k in leaves}
        leaf = max(per_leaf, key=per_leaf.get)
        name = "grad" if key == "grads" else "change"
        out[f"{name}_gap"] = per_leaf[leaf]
        out[f"{name}_median_gap"] = statistics.median(per_leaf.values())
        out[f"{key}_worst_leaf"] = leaf
    out["grad_profile_gap"] = statistics.median(
        float(np.linalg.norm(got["profiles"][k] - want["profiles"][k])
              / max(np.linalg.norm(want["profiles"][k]), 1e-300)) for k in leaves)
    out["change_dist"] = statistics.median(
        float((got["deltas"][k].to(want["deltas"][k].device) - want["deltas"][k]).double().norm())
        / max(want["changes"][k], 1e-300) for k in leaves)
    return out


def check(run: Run, got: dict, device) -> None:
    limits = run.cell.workload["limits"]
    t = perf_counter()
    want = reference_steps(run.cell.config, run.cell.mix, run.seed, device)
    g = gaps(got, want)
    eprint(f"reference over {len(want['losses'])} steps: {perf_counter() - t:.1f} s; "
           f"losses {got['losses']} vs {want['losses']}; worst leaves "
           f"{g['grads_worst_leaf']}, {g['changes_worst_leaf']}")
    for name in ("loss_gap", "loss_step_gap", "ranking_step_gap", "grad_gap", "grad_median_gap",
                 "grad_profile_gap", "change_gap", "change_median_gap", "change_dist"):
        if name in limits:
            run.check(name, g[name], limits[name])
        else:  # read, not compared (PERF.md says why)
            eprint(f"reading {name}: {g[name]!r}")


def calibrate(run: Run, seeds: list[int]) -> list[dict]:
    """For each seed: the program's numbers (one-rank cells; a mesh's come
    from its runs) and the half-batch fault's, planted in the reference
    (half of each batch left out); on the first three seeds also the
    control's (the reference in ``CONTROL`` precision) and, on a mesh, the
    exchange left out; all against the fp32 reference, in one process on
    one card."""
    import torch

    mix, cfg = run.cell.mix, run.cell.config
    ranks = int(mix.get("ranks", 1))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = []
    for i, seed in enumerate(seeds):
        want = reference_steps(cfg, mix, seed, device)
        row = {"seed": seed}
        if ranks == 1:
            trainer = build_trainer(cfg, mix, seed, device)
            got = checked_steps(trainer, make_collator(mix), mix, Traffic(mix, seed))
            got["changes"], got["deltas"] = changes(trainer.params, cfg, seed, device,
                                                    to_host=True)
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            row["program"] = gaps(got, want)
        row["half_batch"] = gaps(reference_steps(cfg, mix, seed, device, keep_rows=0.5), want)
        if i < 3:
            row["control"] = gaps(reference_steps(cfg, mix, seed, device, Precision(CONTROL)),
                                  want)
            if ranks > 1:
                share = int(mix["pairs_per_step"]) // ranks
                row["no_exchange"] = gaps(reference_steps(cfg, mix, seed, device,
                                                          only_rows=share), want)
        row["losses"] = {"reference": want["losses"]}
        eprint(row)
        out.append(row)
    return out
