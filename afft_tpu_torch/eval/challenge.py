"""Marginalization, accuracy breakdowns, late fusion, challenge packaging.

The port's copy of afft_tpu/eval/challenge.py (reference challenge.py —
marginalize_verb_noun :196-210, compute_accuracies_epic :161-193,
epic100_unseen_tail_eval :109-158, get_epic_marginalize_late_fuse :287-351,
get_struct_outputs_per_dataset :354-398, package_results_for_submission_ek100
:401-414). Host-side numpy and pandas; the ranking metrics are the port's
``train.metrics``.

Logits files: ``gen_load_resfiles`` reads the h5 files of
``eval.evaluate.store_append_h5`` (the reference's layout) and the npz files
the port's eval writes where ``h5py`` does not import, with the same keys
(``logits/action_<head>``) and row order. The npz is a second file format
for the same content, not a fallback of the device or of the computation.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import os.path as osp
import zipfile
from typing import Dict, List

import numpy as np
import pandas as pd

from ..data.epic import EPIC100_VERSION
from ..train.metrics import topk_accuracy, topk_recall

LOGITS_DIR = "logits"
PREFIX_H5 = "test"


def softmax(x, axis=-1):
    x = x - np.max(x, axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def allkeys(obj):
    """Recursively find all leaf keys in an h5 file."""
    import h5py
    keys = []
    for key in obj.keys():
        if isinstance(obj[key], h5py.Group):
            keys += [f"{key}/{el}" for el in allkeys(obj[key])]
        else:
            keys.append(key)
    return keys


def gen_load_resfiles(resdir, prefix_h5=None, warn_if_multiple=False):
    """Each logits file ``<prefix>*h5`` or ``<prefix>*npz`` of ``resdir``, in
    sorted order, as {key: array}."""
    prefix = prefix_h5 or PREFIX_H5
    resfiles = sorted(glob.glob(osp.join(resdir, prefix + "*h5")) +
                      glob.glob(osp.join(resdir, prefix + "*npz")))
    if len(resfiles) == 0:
        raise ValueError(f"Didnt find any resfiles in {resdir}")
    if warn_if_multiple and len(resfiles) > 1:
        logging.warning(
            "%d logits files match %s*h5 / %s*npz in %s; only %s is read "
            "(sorted order; reference convention)", len(resfiles), prefix,
            prefix, resdir, resfiles[0])
    for resfile in resfiles:
        output_dict = {}
        if resfile.endswith(".npz"):
            with np.load(resfile) as fin:
                for key in fin.files:
                    output_dict[key] = fin[key]
        else:
            import h5py
            with h5py.File(resfile, "r") as fin:
                for key in allkeys(fin):
                    output_dict[key] = fin[key][()]
        yield output_dict


def compute_accuracy(predictions, labels, classes=None):
    """top1/top5/mt5r (x100) for one label space (reference :94-106)."""
    if classes is not None:
        classes = list(classes.values())
    top_1, top_5 = topk_accuracy(predictions, labels, ks=(1, 5))
    mt5r = topk_recall(predictions, labels, k=5, classes=classes)
    return top_1 * 100, top_5 * 100, mt5r * 100


def epic100_unseen_tail_eval(probs, dataset):
    """Unseen-kitchens and tail-class MT5R breakdowns (reference :109-158)."""
    rdir = dataset.rulstm_annotation_dir
    if rdir is None:
        # optional kwarg (epic.py): without the RULSTM annotation dir the
        # breakdown csvs don't exist — nan metrics, not a crash after the
        # full forward pass has already run. The reference aborts here
        # (challenge.py:109-158); a real EK100 val eval should never take
        # this branch, so name the missing kwarg loudly.
        logging.warning(
            "epic100_unseen_tail_eval: dataset has no "
            "rulstm_annotation_dir (config key "
            "dataset.epic_kitchens100.common.rulstm_annot_dir) — "
            "unseen/tail MT5R breakdowns will be NaN. Set the kwarg to "
            "the RULSTM annotation dir for a full EK100 evaluation.")
        return {k: float("nan") for k in
                ("vmt5r_tail", "nmt5r_tail", "amt5r_tail",
                 "vmt5r_unseen", "nmt5r_unseen", "amt5r_unseen")}
    read_ids = lambda f, col: pd.read_csv(  # noqa: E731
        osp.join(rdir, f), names=[col])[col]
    unseen = read_ids("validation_unseen_participants_ids.csv", "ids")
    tail_verbs = read_ids("validation_tail_verbs_ids.csv", "id")
    tail_nouns = read_ids("validation_tail_nouns_ids.csv", "id")
    tail_actions = read_ids("validation_tail_actions_ids.csv", "id")

    # RULSTM csv loads give a 'uid' column = narration id
    uid_col = ("narration_id" if "narration_id" in dataset.df.columns
               else "uid")
    uids = dataset.df[uid_col]
    unseen_idx = uids.isin(unseen).values
    tv_idx = uids.isin(tail_verbs).values
    tn_idx = uids.isin(tail_nouns).values
    ta_idx = uids.isin(tail_actions).values

    def _mt5r_subset(p, labels, idx):
        # empty subset (e.g. a custom split with no unseen/tail uids) would
        # divide by zero inside topk_recall — the reference aborts here
        # (challenge.py:109-158); report nan instead of killing the eval
        if not idx.any():
            return float("nan")
        return compute_accuracy(p[idx], labels[idx])[2]

    vmt5r_tail = _mt5r_subset(
        probs[0], dataset.df.verb_class.values, tv_idx)
    nmt5r_tail = _mt5r_subset(
        probs[1], dataset.df.noun_class.values, tn_idx)
    amt5r_tail = _mt5r_subset(
        probs[2], dataset.df.action_class.values, ta_idx)
    vmt5r_unseen = _mt5r_subset(
        probs[0], dataset.df.verb_class.values, unseen_idx)
    nmt5r_unseen = _mt5r_subset(
        probs[1], dataset.df.noun_class.values, unseen_idx)
    amt5r_unseen = _mt5r_subset(
        probs[2], dataset.df.action_class.values, unseen_idx)

    return {"vmt5r_tail": vmt5r_tail, "nmt5r_tail": nmt5r_tail,
            "amt5r_tail": amt5r_tail, "vmt5r_unseen": vmt5r_unseen,
            "nmt5r_unseen": nmt5r_unseen, "amt5r_unseen": amt5r_unseen}


def compute_accuracies_epic(probs, dataset, compute_manyshot_unseen_tail=False):
    """top1/top5/mt5r for verb/noun/action (+many-shot/unseen/tail),
    reference :161-193."""
    assert len(probs) == 3, "probs must contain verb, noun and action"
    manyshot = dataset.classes_manyshot

    vtop1, vtop5, vmt5r = compute_accuracy(probs[0],
                                           dataset.df.verb_class.values)
    vmt5r_ms = nmt5r_ms = amt5r_ms = float("nan")
    if "verb" in manyshot and compute_manyshot_unseen_tail:
        _, _, vmt5r_ms = compute_accuracy(
            probs[0], dataset.df.verb_class.values,
            classes=manyshot["verb"])
    ntop1, ntop5, nmt5r = compute_accuracy(probs[1],
                                           dataset.df.noun_class.values)
    if "noun" in manyshot and compute_manyshot_unseen_tail:
        _, _, nmt5r_ms = compute_accuracy(
            probs[1], dataset.df.noun_class.values,
            classes=manyshot["noun"])
    atop1, atop5, amt5r = compute_accuracy(probs[2],
                                           dataset.df.action_class.values)
    if "action" in manyshot and compute_manyshot_unseen_tail:
        _, _, amt5r_ms = compute_accuracy(
            probs[2], dataset.df.action_class.values,
            classes=manyshot["action"])

    res = {"vtop1": vtop1, "vtop5": vtop5, "vmt5r": vmt5r,
           "vmt5r_ms": vmt5r_ms, "ntop1": ntop1, "ntop5": ntop5,
           "nmt5r": nmt5r, "nmt5r_ms": nmt5r_ms, "atop1": atop1,
           "atop5": atop5, "amt5r": amt5r, "amt5r_ms": amt5r_ms}

    if dataset.version == EPIC100_VERSION and compute_manyshot_unseen_tail:
        res.update(epic100_unseen_tail_eval(probs, dataset))
    return res


def marginalize_verb_noun(res_action, dataset, to_prob=True,
                          compute_manyshot_unseen_tail=False):
    """Action logits -> verb/noun scores through the dataset's mapping
    matrices (reference :196-210)."""
    res_action_probs = softmax(res_action, axis=-1) if to_prob else res_action
    cm = dataset.class_mappings
    res_verb = res_action_probs @ np.asarray(cm[("verb", "action")])
    res_noun = res_action_probs @ np.asarray(cm[("noun", "action")])
    accuracies = compute_accuracies_epic(
        [res_verb, res_noun, res_action], dataset,
        compute_manyshot_unseen_tail)
    # actual action scores returned, not probs (AVT / Sener et al. convention)
    return accuracies, [res_verb, res_noun, res_action]


def get_epic_marginalize_verb_noun(resdir, dataset, prefix_h5=None):
    # reference parity: only the FIRST matching h5 is read
    # (reference challenge.py:215 does next(gen_load_resfiles(...)) too);
    # warn so multi-export dirs aren't silently nondeterministic
    gen = gen_load_resfiles(resdir, prefix_h5, warn_if_multiple=True)
    res = next(gen)
    res_action = None
    for key, val in res.items():
        if key.startswith("logits/action"):
            res_action = val
    assert res_action is not None, "Cannot find logits/action in h5 / npz."
    return marginalize_verb_noun(res_action, dataset)


def print_accuracies_epic(metrics: dict, prefix: str = ""):
    print(f"[{prefix}] Accuracies verb/noun/action: "
          f"{metrics['vtop1']:.1f} {metrics['vtop5']:.1f} "
          f"{metrics['ntop1']:.1f} {metrics['ntop5']:.1f} "
          f"{metrics['atop1']:.1f} {metrics['atop5']:.1f} ")
    print(f"[{prefix}] Mean top 5 verb/noun/action: "
          f"{metrics['vmt5r']:.1f} {metrics['nmt5r']:.1f} "
          f"{metrics['amt5r']:.1f} ")
    print(f"[{prefix}] Mean top 5 many shot verb/noun/action: "
          f"{metrics['vmt5r_ms']:.1f} {metrics['nmt5r_ms']:.1f} "
          f"{metrics['amt5r_ms']:.1f} ")
    if "vmt5r_tail" in metrics:
        print(f"[{prefix}] Mean top 5 tail verb/noun/action: "
              f"{metrics['vmt5r_tail']:.1f} {metrics['nmt5r_tail']:.1f} "
              f"{metrics['amt5r_tail']:.1f} ")
        print(f"[{prefix}] Mean top 5 unseen verb/noun/action: "
              f"{metrics['vmt5r_unseen']:.1f} {metrics['nmt5r_unseen']:.1f} "
              f"{metrics['amt5r_unseen']:.1f} ")


def _concat_with_uids(scores, dataset, uid_key):
    return [
        dict(zip([str(el) for el in dataset.df[uid_key].values],
                 scores_per_space))
        for scores_per_space in scores
    ]


def _normalize_scores(scores, p):
    res = []
    for scores_per_space in scores:
        res.append({
            uid: val / (np.linalg.norm(val, ord=p, axis=-1) + 1e-6)
            for uid, val in scores_per_space.items()})
    return res


def read_all_single_models(resdirs, dataset, uid_key="uid",
                           normalize_before_combine=None, prefix_h5=None):
    all_scores = []
    for resdir in resdirs:
        accuracies, scores = get_epic_marginalize_verb_noun(
            resdir, dataset, prefix_h5)
        scores = _concat_with_uids(scores, dataset, uid_key)
        print_accuracies_epic(accuracies, prefix=resdir)
        if normalize_before_combine is not None:
            scores = _normalize_scores(scores, p=normalize_before_combine)
        all_scores.append(scores)
    return all_scores


def get_epic_marginalize_late_fuse(resdirs, dataset, weights=1.0,
                                   uid_key="uid", prefix_h5=None):
    """Weighted late fusion of per-model h5 logits (reference :287-351)."""
    if not isinstance(resdirs, list):
        resdirs = [resdirs]
    if isinstance(weights, float):
        weights = [[weights] * len(resdirs)]
    elif not any(isinstance(el, (list, tuple)) for el in weights):
        assert len(weights) == len(resdirs)
        weights = [weights]
    else:
        assert all(len(w) == len(resdirs) for w in weights)

    all_scores = read_all_single_models(resdirs, dataset, uid_key,
                                        prefix_h5=prefix_h5)
    accuracies, combined = None, None
    best = (-np.inf, None)
    for weight in weights:
        combined = []
        for space_id in range(3):  # verb / noun / action
            scores_for_space = [s[space_id] for s in all_scores]
            total_uids = set.union(*[set(el.keys())
                                     for el in scores_for_space])
            combined_for_space = {}
            for uid in total_uids:
                parts = [s[uid] * w for s, w in zip(scores_for_space, weight)
                         if uid in s]
                combined_for_space[uid] = np.sum(np.stack(parts), axis=0)
            combined.append(combined_for_space)
        combined_np = [
            np.array([c[str(uid)] for uid in dataset.df[uid_key].values])
            for c in combined
        ]
        accuracies = compute_accuracies_epic(combined_np, dataset)
        print_accuracies_epic(accuracies, prefix=f"combined with {weight}")
        if accuracies["amt5r"] > best[0]:
            best = (accuracies["amt5r"], weight)
    logging.info("best weights: %s (amt5r %.2f)", best[1], best[0])
    # reference parity: the LAST weight combination's accuracies/combined
    # are returned (reference challenge.py:287-351 does the same; its
    # mp_best_weights side list only tracks the best). Pass the best
    # combo as the final element of ``weights`` to package it.
    return accuracies, combined, dataset


def get_struct_outputs_per_dataset(resdirs, dataset, weights,
                                   uid_key="uid", prefix_h5=None):
    """Per-uid score dicts for challenge submission (reference :354-398)."""
    _, combined, dataset = get_epic_marginalize_late_fuse(
        resdirs, dataset, weights, uid_key=uid_key, prefix_h5=prefix_h5)
    results = {}
    action_to_verb_noun = {v: k for k, v in
                           dataset.verb_noun_to_action.items()}

    for uid in combined[0]:
        verb_res = {f"{j}": float(v) for j, v in enumerate(combined[0][uid])}
        noun_res = {f"{j}": float(v) for j, v in enumerate(combined[1][uid])}
        k = min(100, len(combined[2][uid]))
        top_100 = sorted(np.argpartition(combined[2][uid], -k)[-k:],
                         key=lambda x: -combined[2][uid][x])
        action_res = {
            ",".join(str(el) for el in action_to_verb_noun[j]):
                float(combined[2][uid][j])
            for j in top_100
        }
        results[f"{uid}"] = {"verb": verb_res, "noun": noun_res,
                             "action": action_res}

    # discarded (too-short) segments get uniform scores (reference :379-392)
    if dataset.discarded_df is not None:
        for _, row in dataset.discarded_df.iterrows():
            if str(row[uid_key]) in results:
                continue
            results[f"{row[uid_key]}"] = {
                "verb": {f"{j}": 0.0
                         for j in range(len(dataset.verb_classes))},
                "noun": {f"{j}": 0.0
                         for j in range(len(dataset.noun_classes))},
                "action": {f"0,{j}": 0.0 for j in range(100)},
            }
    return {"version": f"{dataset.version}",
            "challenge": dataset.challenge_type,
            "results": results}


def package_results_for_submission_ek100(resdirs, dataset, weights,
                                         sls=(1, 4, 3), output_dir=LOGITS_DIR,
                                         uid_key="uid", prefix_h5=None):
    res = get_struct_outputs_per_dataset(resdirs, dataset, weights,
                                         uid_key=uid_key, prefix_h5=prefix_h5)
    res["sls_pt"], res["sls_tl"], res["sls_td"] = sls
    os.makedirs(output_dir, exist_ok=True)
    json_path = osp.join(output_dir, "test.json")
    with open(json_path, "w") as fout:
        json.dump(res, fout, indent=4)
    with zipfile.ZipFile(osp.join(output_dir, "submit.zip"), "w",
                         zipfile.ZIP_DEFLATED) as zf:
        zf.write(json_path, "test.json")
    print("Packaged challenge submission to", output_dir)
