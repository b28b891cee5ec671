"""Write a markdown run log from `tools.run_100k`'s JSONL (counterpart
of tools/summarize_100k.py, whose tables it writes):

    python -m s_volsdf_tpu_torch.tools.summarize_100k run100k.jsonl \\
        [RUNLOG_100K.md]

The header names the card the rows carry ("card": the name and power
limit of the card each process ran on)."""

import json
import os
import sys


def _chunk_n(r, rows):
    """Steps covered by row r: the recorded n (new logs) or the median
    step delta of r's phase (older logs without per-row n)."""
    if "n" in r:
        return r["n"]
    phase = [s["step"] for s in rows if s["phase"] == r["phase"]]
    deltas = sorted(b - a for a, b in zip(phase, phase[1:]) if b > a)
    return deltas[len(deltas) // 2] if deltas else r["step"]


def main(jsonl_path: str, out_path: str = "RUNLOG_100K.md"):
    rows, done = [], None
    for line in open(jsonl_path):
        rec = json.loads(line)
        if rec.get("done"):
            done = rec
        else:
            rows.append(rec)

    cards = sorted({r["card"] for r in rows + [done or {}] if "card" in r})
    card = " / ".join(cards) if cards else "an unrecorded device"
    initial = [r for r in rows if r["phase"] == "initial"]
    resume = [r for r in rows if r["phase"] == "resume"]
    crash_step = initial[-1]["step"] if resume else None
    resume_start = (resume[0]["step"] - _chunk_n(resume[0], rows)
                    if resume else None)
    # Steps the resume phase re-executed because the kill landed after
    # the last periodic checkpoint (0 when a kill-site checkpoint was
    # written — the weaker pre-r3 protocol).
    replayed = (crash_step - resume_start) if resume else 0

    def fmt(r):
        return (f"| {r['step']:>6} | {r['loss']:.4f} | {r['psnr']:6.2f} | "
                f"{r['beta']:.4f} | {r['mvs']:.5f} | {r['guard_trips']} | "
                f"{r['chunk_s']:6.2f} |")

    # Sample the trajectory every ~5k steps plus first/last of each
    # phase and the crash/resume boundary.
    marks = set()
    for r in rows:
        if r["step"] % 5000 < _chunk_n(r, rows) or r is rows[0] \
                or r is rows[-1]:
            marks.add(r["step"])
    if crash_step:
        marks.add(crash_step)
        marks.add(resume[0]["step"])

    step_ms = [r["chunk_s"] / _chunk_n(r, rows) * 1000 for r in rows[2:]]
    steady = sorted(step_ms)[len(step_ms) // 2]
    total_wall = (initial[-1]["wall"] if initial else 0) + \
        (resume[-1]["wall"] if resume else 0)
    opt_s = sum(r["chunk_s"] for r in rows)
    n_steps = done["steps"] if done else rows[-1]["step"]

    with open(out_path, "w") as f:
        w = f.write
        w("# RUNLOG — full production schedule (opt_stepNs=[100000,0,0])"
          "\n\n")
        w("The reference's published protocol "
          "(`/root/reference/README.md:40-42`, `config/ours.yaml`) run "
          f"end to end by the PyTorch port on one {card}: a "
          "production-scale synthetic DTU scene (576x768 VolSDF res, x2 "
          "MVS res), stage-0 MVS volumes -> VolSDF steps (512 rays/step) "
          "with the port's chunked trainer, MVS GCE regularization, "
          "checkpoints, and a HARD KILL (os._exit"
          f"{', no kill-site checkpoint' if replayed else ''}) at step "
          f"{crash_step} followed by `is_continue` resume from the "
          "latest checkpoint (the pixel/sampler generator is "
          "checkpointed).\n\n")
        w("Produced by `python -m s_volsdf_tpu_torch.tools.run_100k`; raw "
          f"telemetry in `{os.path.basename(jsonl_path)}`.\n\n")
        w("## Trajectory (sampled every ~5k steps)\n\n")
        w("| step | loss | PSNR | beta | mvs loss | guard trips | "
          "chunk s |\n|---|---|---|---|---|---|---|\n")
        last_phase = None
        for r in rows:
            if r["step"] in marks:
                if r["phase"] != last_phase:
                    w(f"| *{r['phase']} phase* | | | | | | |\n")
                    last_phase = r["phase"]
                w(fmt(r) + "\n")
        w("\n## Outcome\n\n")
        if done:
            w(f"- completed steps: **{done['steps']}**\n")
            w(f"- NaN-guard trips: **{done['guard_trips']}** (in the "
              "resume phase; phase-1 trips are in its own rows)\n")
            w(f"- cascade stage-0 wall: {done['cascade_s']}s\n")
            w(f"- feedback render (576x768 depth): "
              f"{done['feedback_render_s']}s\n")
            w(f"- feedback depth range: {done['depth_range']}\n")
        w(f"- steady-state step time: **{steady:.1f} ms** "
          f"({512 / steady * 1000:,.0f} rays/s)\n")
        w(f"- pure optimization wall (sum of chunks): {opt_s/60:.1f} min "
          f"for {n_steps:,} steps\n")
        w(f"- total wall incl. fixture+compile+cascade+checkpoints, "
          f"both phases: {total_wall/60:.1f} min\n")
        w("- reference estimate for the same schedule: ~8 h on one "
          "GPU (BASELINE.md: ~3.4 it/s x 100k).\n\n")
        w("## Resume continuity\n\n")
        if resume:
            a = initial[-1]
            b = resume[0]
            if replayed:
                w(f"Phase 1 was killed with `os._exit(17)` after step "
                  f"{a['step']} (loss {a['loss']:.4f}, PSNR "
                  f"{a['psnr']:.2f}, beta {a['beta']:.4f}) **without "
                  f"writing a checkpoint at the kill site** — recovery "
                  f"is from the last periodic checkpoint at step "
                  f"{resume_start}, exactly what a real SIGKILL leaves "
                  f"behind. Phase 2 re-executed the {replayed} lost "
                  f"steps and its first chunk landed at step "
                  f"{b['step']}: loss {b['loss']:.4f}, PSNR "
                  f"{b['psnr']:.2f}, beta {b['beta']:.4f} — continuous "
                  "with the pre-kill trajectory (the trainer restores "
                  "the generator from the checkpoint, so the "
                  "resumed pixel/sampler stream is the one an "
                  "uninterrupted run would have used).\n")
            else:
                w(f"Phase 1 checkpointed and exited (os._exit) after "
                  f"step {a['step']} (loss {a['loss']:.4f}, PSNR "
                  f"{a['psnr']:.2f}, beta {a['beta']:.4f}); phase 2 "
                  f"resumed from that checkpoint and its first chunk "
                  f"landed at step {b['step']}: loss {b['loss']:.4f}, "
                  f"PSNR {b['psnr']:.2f}, beta {b['beta']:.4f} — "
                  "continuous with the pre-kill trajectory.\n")
            # Replay determinism: rows in both phases at the same step.
            by_step = {r["step"]: r for r in initial}
            overlaps = [(by_step[r["step"]], r) for r in resume
                        if r["step"] in by_step]
            if overlaps:
                ok = sum(1 for x, y in overlaps
                         if abs(x["loss"] - y["loss"]) < 5e-4)
                w(f"\nReplay determinism: {len(overlaps)} chunk(s) were "
                  f"executed in BOTH phases (steps "
                  f"{[x['step'] for x, _ in overlaps]}); {ok}/"
                  f"{len(overlaps)} reproduce the original loss to "
                  "<5e-4 — the checkpointed generator replays the "
                  "identical optimization.\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main(*sys.argv[1:])
