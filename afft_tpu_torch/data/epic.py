"""EPIC-Kitchens-55/100 and EGTEA Gaze+ dataset.

Port of afft_tpu/data/epic.py. Behavioural reference: datasets/epic_kitchens.py in the upstream repo
(EPICKitchens :20-276): original pkl and RULSTM csv annotation parsing,
verb/noun class CSVs, action-class construction, verb/noun->action mapping
matrices, EPIC-55 many-shot class subsets.
"""

from __future__ import annotations

import csv
import logging
import pickle as pkl
from collections import OrderedDict
from datetime import date, datetime
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np
import pandas as pd

from .anticipation import RULSTM_TSN_FPS
from .dataset import FeatureClipDataset

EGTEA_VERSION = -1
EPIC55_VERSION = 0.1
EPIC100_VERSION = 0.2


def _timestr_to_sec(s, fmt="%H:%M:%S.%f"):
    timeobj = datetime.strptime(s, fmt).time()
    td = datetime.combine(date.min, timeobj) - datetime.min
    return td.total_seconds()


class EPICKitchens(FeatureClipDataset):
    """EPICKitchens and EGTEA loader (reference datasets/epic_kitchens.py)."""

    def __init__(self,
                 annotation_path: Sequence[str],
                 action_labels_fpath: str = None,
                 annotation_dir: str = None,
                 rulstm_annotation_dir: str = None,
                 version: float = EPIC55_VERSION,
                 **other_kwargs):
        self.version = version
        df = pd.concat([self._load_df(str(el)) for el in annotation_path])
        df = df.reset_index(drop=True)
        # optional for EGTEA/version=-1 (class CSVs are not read there)
        self.annotation_dir = Path(annotation_dir) \
            if annotation_dir is not None else None
        self.rulstm_annotation_dir = rulstm_annotation_dir

        epic_postfix = "_100" if self.version == EPIC100_VERSION else ""
        if self.version != EGTEA_VERSION:
            verb_classes = self._load_class_names(
                self.annotation_dir / f"EPIC{epic_postfix}_verb_classes.csv")
            noun_classes = self._load_class_names(
                self.annotation_dir / f"EPIC{epic_postfix}_noun_classes.csv")
        else:
            verb_classes, noun_classes = {}, {}

        if action_labels_fpath is not None:
            load_action_fn = (self._load_action_classes_egtea
                              if self.version == EGTEA_VERSION
                              else self._load_action_classes)
            action_classes, verb_noun_to_action = load_action_fn(
                action_labels_fpath)
        else:
            logging.warning("Action labels not provided; generating actions")
            action_classes, verb_noun_to_action = self._gen_all_actions(
                list(verb_classes), list(noun_classes))

        if "action_class" not in df.columns and \
                {"noun_class", "verb_class"}.issubset(df.columns):
            df.loc[:, "action_class"] = [
                verb_noun_to_action.get((v, n), -1)
                for v, n in zip(df.verb_class, df.noun_class)]
        elif "action_class" not in df.columns:
            df.loc[:, "action_class"] = -1
            df.loc[:, "verb_class"] = -1
            df.loc[:, "noun_class"] = -1
        num_undef = int((df["action_class"] == -1).sum())
        if num_undef > 0:
            logging.error("No valid action label for %d/%d samples!",
                          num_undef, len(df))

        other_kwargs["verb_classes"] = verb_classes
        other_kwargs["noun_classes"] = noun_classes
        other_kwargs["action_classes"] = action_classes
        super().__init__(df, **other_kwargs)
        self.verb_noun_to_action = verb_noun_to_action
        logging.info("Created EPIC %s dataset with %d samples",
                     self.version, len(self))

    # -- class mapping matrices ------------------------------------------
    @property
    def class_mappings(self) -> Dict[Tuple[str, str], np.ndarray]:
        """One-hot (n_actions, n_verbs/nouns) marginalization matrices
        (reference :87-106)."""
        # fallback sizing (no class CSVs) must be max id + 1, not the
        # count of DISTINCT ids: non-contiguous verb/noun/action ids would
        # index past a distinct-count-sized matrix
        def _fallback(ids):
            ids = list(ids)
            return (max(ids) + 1) if ids else 0

        num_verbs = len(self.verb_classes) or _fallback(
            v for (v, _) in self.verb_noun_to_action)
        num_nouns = len(self.noun_classes) or _fallback(
            n for (_, n) in self.verb_noun_to_action)
        num_actions = len(self.action_classes) or _fallback(
            self.verb_noun_to_action.values())
        verb_in_action = np.zeros((num_actions, num_verbs), np.float32)
        noun_in_action = np.zeros((num_actions, num_nouns), np.float32)
        for (verb, noun), action in self.verb_noun_to_action.items():
            verb_in_action[action, verb] = 1.0
            noun_in_action[action, noun] = 1.0
        return {("verb", "action"): verb_in_action,
                ("noun", "action"): noun_in_action}

    @property
    def classes_manyshot(self) -> OrderedDict:
        """EPIC-55 many-shot subsets (reference :108-137). Cached: the
        value is immutable after __init__ and naive recomputation costs
        two CSV reads plus an O(actions x many_shot) scan per access."""
        if self.version != EPIC55_VERSION:
            return super().classes_manyshot
        if getattr(self, "_classes_manyshot_cache", None) is not None:
            return self._classes_manyshot_cache
        many_shot_verbs = {
            el["verb"]: el["verb_class"] for el in pd.read_csv(
                self.annotation_dir / "EPIC_many_shot_verbs.csv"
            ).to_dict("records")}
        many_shot_nouns = {
            el["noun"]: el["noun_class"] for el in pd.read_csv(
                self.annotation_dir / "EPIC_many_shot_nouns.csv"
            ).to_dict("records")}
        verb_ids = set(many_shot_verbs.values())
        noun_ids = set(many_shot_nouns.values())
        many_shot_actions = {}
        action_names = {v: k for k, v in self.action_classes.items()}
        for (verb_id, noun_id), action_id in self.verb_noun_to_action.items():
            if verb_id in verb_ids or noun_id in noun_ids:
                many_shot_actions[action_names[action_id]] = action_id
        self._classes_manyshot_cache = OrderedDict([
            ("verb", many_shot_verbs),
            ("noun", many_shot_nouns),
            ("action", many_shot_actions)])
        return self._classes_manyshot_cache

    # -- class/annotation files ------------------------------------------
    def _load_class_names(self, annot_path: Path) -> Dict[str, int]:
        res = {}
        key = "class_key" if self.version == EPIC55_VERSION else "key"
        with open(annot_path) as fin:
            for lno, line in enumerate(csv.DictReader(fin, delimiter=",")):
                res[line[key]] = lno
        return res

    @staticmethod
    def _load_action_classes(path) -> Tuple[Dict[str, int],
                                            Dict[Tuple[int, int], int]]:
        class_names, verb_noun_to_action = {}, {}
        with open(path) as fin:
            for lno, line in enumerate(csv.DictReader(fin, delimiter=",")):
                class_names[line["action"]] = lno
                verb_noun_to_action[(int(line["verb"]),
                                     int(line["noun"]))] = int(line["id"])
        return class_names, verb_noun_to_action

    @staticmethod
    def _load_action_classes_egtea(path) -> Tuple[Dict[str, int],
                                                  Dict[Tuple[int, int], int]]:
        class_names, verb_noun_to_action = {}, {}
        with open(path) as fin:
            reader = csv.DictReader(fin, delimiter=",",
                                    fieldnames=["id", "verb_noun", "action"])
            for lno, line in enumerate(reader):
                class_names[line["action"]] = lno
                verb, noun = [int(el) for el in line["verb_noun"].split("_")]
                verb_noun_to_action[(verb, noun)] = int(line["id"])
        return class_names, verb_noun_to_action

    @staticmethod
    def _gen_all_actions(verb_classes: List[str], noun_classes: List[str]):
        class_names, verb_noun_to_action = {}, {}
        action_id = 0
        for verb_id, verb_cls in enumerate(verb_classes):
            for noun_id, noun_cls in enumerate(noun_classes):
                class_names[f"{verb_cls}:{noun_cls}"] = action_id
                verb_noun_to_action[(verb_id, noun_id)] = action_id
                action_id += 1
        return class_names, verb_noun_to_action

    # -- annotation loading -----------------------------------------------
    def _load_df(self, annotation_path: str) -> pd.DataFrame:
        if annotation_path.endswith(".pkl"):
            return self._init_df_orig(annotation_path)
        if annotation_path.endswith(".csv"):
            return self._init_df_rulstm(annotation_path)
        raise NotImplementedError(annotation_path)

    def _init_df_orig(self, annotation_path):
        """Original EPIC pkl annotations (reference :212-239)."""
        logging.info("Loading original EPIC pkl annotations %s",
                     annotation_path)
        with open(annotation_path, "rb") as fin:
            df = pkl.load(fin)
        df = df.reset_index(drop=False)
        df.loc[:, "start"] = df.start_timestamp.apply(_timestr_to_sec)
        df.loc[:, "end"] = df.stop_timestamp.apply(_timestr_to_sec)
        if "noun" in df.columns:
            df.loc[:, "noun"] = df.loc[:, "noun"].apply(
                lambda s: " ".join(s.replace(":", " ").split(" ")[::-1]))
        if "verb" in df.columns:
            df.loc[:, "verb"] = df.loc[:, "verb"].apply(
                lambda s: " ".join(s.replace("-", " ").split(" ")))
        df = self._gen_vidpath(df)
        return df.reset_index(drop=True)

    def _init_df_rulstm(self, annotation_path):
        """RULSTM csv annotations at 30 fps (reference :249-267)."""
        logging.info("Loading RULSTM EPIC csv annotations %s", annotation_path)
        df = pd.read_csv(
            annotation_path,
            names=["uid", "video_id", "start_frame_30fps", "end_frame_30fps",
                   "verb_class", "noun_class", "action_class"],
            index_col=0, skipinitialspace=True,
            dtype={"uid": str, "video_id": str, "start_frame_30fps": int,
                   "end_frame_30fps": int, "verb_class": int,
                   "noun_class": int, "action_class": int})
        df = df.reset_index(drop=False)
        df.loc[:, "start"] = df.start_frame_30fps / RULSTM_TSN_FPS
        df.loc[:, "end"] = df.end_frame_30fps / RULSTM_TSN_FPS
        df.loc[:, "participant_id"] = df.video_id.apply(
            lambda x: x.split("_")[0])
        df = self._gen_vidpath(df)
        return df.reset_index(drop=True)

    def _gen_vidpath(self, df):
        if self.version == EGTEA_VERSION:
            df.loc[:, "video_path"] = df.video_id.apply(
                lambda v: str(Path(v + ".mp4")))
        else:
            df.loc[:, "video_path"] = df.apply(
                lambda x: str(Path(x.participant_id) / (x.video_id + ".MP4")),
                axis=1)
        return df
