"""Anticipation window conversion.

Port of afft_tpu/data/anticipation.py. Behavioural reference: datasets/base_video_dataset.py:35-91 in the upstream
repo (itself from AVT). Rewrites an action-segment annotation DataFrame so
each row's [start, end] becomes the *observed* window
[action_start - tau_a - tau_o, action_start - tau_a], keeps the original
extent in orig_start/orig_end, adds future_i_{start,end} columns, and drops
rows whose observed window has less than one feature frame of context.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import pandas as pd

RULSTM_TSN_FPS = 30.0  # frame rate the RULSTM features were stored at
FUTURE_PREFIX = "future"


def convert_to_anticipation(df: pd.DataFrame,
                            tau_a: float = 1,
                            tau_o: float = 10,
                            future_clip_ratios: Sequence[float] = (1.0,),
                            drop_style: str = "correct",
                            ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    if tau_a == -999:
        # recognition mode: observed window == the action segment itself
        tau_a = df.loc[:, "start"] - df.loc[:, "end"]
        tau_o = df.loc[:, "end"] - df.loc[:, "start"]

    df = df.copy()
    df.loc[:, "orig_start"] = df.start
    df.loc[:, "orig_end"] = df.end
    df.loc[:, "end"] = df.loc[:, "start"] - tau_a
    df.loc[:, "start"] = df.loc[:, "end"] - tau_o

    for i, ratio in enumerate(future_clip_ratios):
        # -999 copies the ALREADY-REWRITTEN observed window (start/end were
        # mutated above) — reference parity (base_video_dataset.py:60-63
        # does the same); it equals the original clip only in recognition
        # mode (tau_a == -999)
        if ratio == -999:
            df.loc[:, f"{FUTURE_PREFIX}_{i}_start"] = df.loc[:, "start"]
            df.loc[:, f"{FUTURE_PREFIX}_{i}_end"] = df.loc[:, "end"]
        elif -10 < ratio < 10:
            eff_tau_a = tau_a * ratio
            df.loc[:, f"{FUTURE_PREFIX}_{i}_start"] = df.loc[:, "end"] + eff_tau_a
            df.loc[:, f"{FUTURE_PREFIX}_{i}_end"] = (
                df.loc[:, f"{FUTURE_PREFIX}_{i}_start"] + tau_o)
        else:
            raise ValueError(f"Seems out of bound {ratio}")

    f1_sec = 1 / RULSTM_TSN_FPS
    old_df = df
    if drop_style == "correct":
        df = df[df.end >= f1_sec]           # at least 1 frame of context
    elif drop_style == "full_context_in":
        df = df[df.start >= f1_sec]         # the whole window must exist
    elif drop_style == "action_banks":
        df = df[df.end >= 2]
    else:
        raise NotImplementedError(f"Unknown style {drop_style}")

    discarded_df = pd.concat([old_df, df]).drop_duplicates(subset=["uid"],
                                                           keep=False)
    df = df.reset_index(drop=True)
    return df, discarded_df
