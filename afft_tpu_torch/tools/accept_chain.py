"""The full-chain acceptance run through the port's own entry points.

    python -m afft_tpu_torch.tools.accept_chain [workdir] [--device cuda]

In ``workdir`` (default ``build/accept_chain``), one after another, each as
its own process:

1. ``python -m afft_tpu_torch.tools.make_accept_dataset`` (the full set: 32
   train and 2 val videos of 256 clips);
2. ``python -m afft_tpu_torch.run -c expts/98_synth_accept_train.txt -m
   train`` (15 epochs);
3. ``python -m afft_tpu_torch.run -c expts/98_synth_accept_val.txt -m
   test`` (the best checkpoint's logits, ``+save_name=test.h5``: h5, or npz
   where h5py does not import);
4. ``python -m afft_tpu_torch.challenge`` with ACCEPT_r04.json's arguments
   (``logits/test.json``, ``logits/submit.zip``).

Prints one JSON line: the card (``nvidia-smi`` name and power limit), each
step's seconds, the training run's epochs (loss, val MT5R, clips/s), the
eval run's record and the challenge's verb / noun / action top-1 / top-5 and
action MT5R from the submission's logits, beside ACCEPT_r04.json's.
Each process's output is in ``<workdir>/<step>.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
EXPTS = os.path.join(REPO, "expts")
MODEL = "CMFPEarly_ModalTokenCMFuser_rgb_objects_audio_flow_synth-accept"
OVERRIDES = ("use_wandb=false",)
TIMEOUT = 3000  # seconds a step may take


def _run(cmd, workdir, name):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    with open(os.path.join(workdir, f"{name}.log"), "w") as out:
        proc = subprocess.run(cmd, cwd=workdir, env=env, stdout=out,
                              stderr=subprocess.STDOUT, timeout=TIMEOUT)
    seconds = time.perf_counter() - t0
    with open(os.path.join(workdir, f"{name}.log")) as f:
        text = f.read()
    if proc.returncode != 0:
        sys.exit(f"{name}: exit code {proc.returncode}\n{text[-4000:]}")
    return text, seconds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("workdir", nargs="?",
                    default=os.path.join(REPO, "build", "accept_chain"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    py = sys.executable
    seconds = {}
    _, seconds["make_accept_dataset"] = _run(
        [py, "-m", "afft_tpu_torch.tools.make_accept_dataset"], args.workdir,
        "make_accept_dataset")
    _, seconds["train"] = _run(
        [py, "-m", "afft_tpu_torch.run", "-c",
         os.path.join(EXPTS, "98_synth_accept_train.txt"), "-m", "train",
         "--device", args.device, *OVERRIDES], args.workdir, "train")
    text, seconds["test"] = _run(
        [py, "-m", "afft_tpu_torch.run", "-c",
         os.path.join(EXPTS, "98_synth_accept_val.txt"), "-m", "test",
         "--device", args.device, *OVERRIDES], args.workdir, "test")
    eval_run = json.loads([line for line in text.splitlines()
                           if "eval run: " in line][-1]
                          .split("eval run: ", 1)[1])
    with open(os.path.join(REPO, "ACCEPT_r04.json")) as f:
        recorded = json.load(f)
    challenge_args = recorded["entry_points"][-1].split()
    challenge_args = challenge_args[challenge_args.index("--prefix_h5"):]
    _, seconds["challenge"] = _run(
        [py, "-m", "afft_tpu_torch.challenge", *challenge_args],
        args.workdir, "challenge")

    sys.path.insert(0, REPO)
    from afft_tpu_torch import challenge as PCHALLENGE
    from afft_tpu_torch.eval import challenge as PC
    overrides = challenge_args[challenge_args.index("--override") + 1:]
    cwd = os.getcwd()
    os.chdir(args.workdir)
    try:
        dataset = PCHALLENGE.get_dataset(overrides, "test")
        (logits,) = PC.gen_load_resfiles(os.path.join(PC.LOGITS_DIR, MODEL),
                                         "test")
    finally:
        os.chdir(cwd)
    accs, _ = PC.marginalize_verb_noun(logits["logits/action_all-fused"],
                                       dataset)
    keys = ("vtop1", "vtop5", "ntop1", "ntop5", "atop1", "atop5")
    with open(os.path.join(args.workdir, "checkpoints", MODEL,
                           "metrics.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    with open(os.path.join(args.workdir, PC.LOGITS_DIR, "test.json")) as f:
        n_results = len(json.load(f)["results"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    got = {"verb_noun_action_top1_top5": [accs[k] for k in keys],
           "amt5r": accs["amt5r"]}
    want = {k: recorded["challenge"][k] for k in got}
    print(json.dumps({
        "card": smi, "seconds": seconds,
        "epochs": [{k: e.get(k) for k in (
            "_step", "train_total_loss", "val_mt5r_action_all-fused",
            "clips_per_s", "window_ms", "iters")} for e in epochs],
        "eval": eval_run, "submission_results": n_results,
        "challenge": got, "recorded_tpu": want, "met": got == want}))


if __name__ == "__main__":
    main()
