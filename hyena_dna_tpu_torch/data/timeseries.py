"""Informer ETT time-series datasets (a copy of
`hyena_dna_tpu/data/timeseries.py`; upstream `src/dataloaders/et.py:228-626`).

`InformerDataset` over the ETT electricity-transformer CSVs: standardised
feature windows of seq_len plus a zero-padded pred_len, forecast targets of
pred_len, integer time-feature marks and a prediction mask; the hour and
minute variants differ only in their split borders.

CSV-native in numpy (upstream uses pandas); the timeenc=0 integer marks
(month, day, weekday, hour[, minute bucket]) are the mode the configs use.
"""

from __future__ import annotations

import csv
from datetime import datetime
from typing import Optional, Tuple

import numpy as np


class StandardScaler:
    def __init__(self):
        self.mean = 0.0
        self.std = 1.0

    def fit(self, data: np.ndarray):
        self.mean = data.mean(0)
        self.std = data.std(0)
        self.std = np.where(self.std == 0, 1.0, self.std)

    def transform(self, data: np.ndarray) -> np.ndarray:
        return (data - self.mean) / self.std

    def inverse_transform(self, data: np.ndarray) -> np.ndarray:
        return data * self.std + self.mean


def _read_csv(path: str) -> Tuple[list, np.ndarray, list]:
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        dates, rows = [], []
        for row in reader:
            dates.append(datetime.fromisoformat(row[0]))
            rows.append([float(v) for v in row[1:]])
    return header[1:], np.asarray(rows, dtype=np.float64), dates


def _time_marks(dates, freq: str) -> np.ndarray:
    marks = [
        [d.month, d.day, d.weekday(), d.hour] + ([d.minute // 15] if freq == "t" else [])
        for d in dates
    ]
    return np.asarray(marks, dtype=np.int64)


class InformerDataset:
    """ETT window dataset; items are (seq_x, seq_y, mark, mask)."""

    def __init__(
        self,
        data_path: str,
        flag: str = "train",
        size: Optional[Tuple[int, int, int]] = None,  # (seq_len, label_len, pred_len)
        features: str = "S",
        target: str = "OT",
        scale: bool = True,
        freq: str = "h",
        eval_stamp: bool = False,
        eval_mask: bool = False,
    ):
        if size is None:
            self.seq_len, self.label_len, self.pred_len = 24 * 4 * 4, 24 * 4, 24 * 4
        else:
            self.seq_len, self.label_len, self.pred_len = size
        assert flag in ("train", "val", "test")
        self.set_type = {"train": 0, "val": 1, "test": 2}[flag]
        self.features = features
        self.target = target
        self.scale = scale
        self.freq = freq
        self.eval_stamp = eval_stamp
        self.eval_mask = eval_mask
        self.forecast_horizon = self.pred_len
        self.scaler = StandardScaler()
        self._load(data_path)

    def _borders(self, n: int):
        num_train = int(n * 0.7)
        num_test = int(n * 0.2)
        num_vali = n - num_train - num_test
        border1s = [0, num_train - self.seq_len, n - num_test - self.seq_len]
        border2s = [num_train, num_train + num_vali, n]
        return border1s, border2s

    def _load(self, path: str):
        cols, values, dates = _read_csv(path)
        if self.features in ("M", "MS"):
            data_cols = list(range(len(cols)))
        else:  # 'S': target only
            data_cols = [cols.index(self.target)]
        df_data = values[:, data_cols]

        b1s, b2s = self._borders(len(values))
        b1, b2 = b1s[self.set_type], b2s[self.set_type]
        if self.scale:
            self.scaler.fit(df_data[b1s[0] : b2s[0]])
            data = self.scaler.transform(df_data)
        else:
            data = df_data
        self.data_x = data[b1:b2]
        self.data_y = data[b1:b2]
        self.data_stamp = _time_marks(dates[b1:b2], self.freq)

    def __len__(self) -> int:
        return len(self.data_x) - self.seq_len - self.pred_len + 1

    def __getitem__(self, index: int, rng=None):
        s_begin = index
        s_end = s_begin + self.seq_len
        r_end = s_end - self.label_len + self.label_len + self.pred_len

        seq_x = np.concatenate(
            [self.data_x[s_begin:s_end],
             np.zeros((self.pred_len, self.data_x.shape[-1]))],
            axis=0,
        ).astype(np.float32)
        seq_y = self.data_y[s_end:r_end].astype(np.float32)

        if self.eval_stamp:
            mark = self.data_stamp[s_begin:r_end]
        else:
            mark = np.concatenate(
                [self.data_stamp[s_begin:s_end],
                 np.zeros((self.pred_len, self.data_stamp.shape[-1]))],
                axis=0,
            )
        mask_val = 1 if self.eval_mask else 0
        mask = np.concatenate(
            [np.zeros(self.seq_len), np.full(self.pred_len, mask_val)]
        )[:, None].astype(np.int64)
        return seq_x, seq_y, {"mark": mark.astype(np.int64), "mask": mask}

    @property
    def d_input(self) -> int:
        return self.data_x.shape[-1]

    @property
    def d_output(self) -> int:
        if self.features in ("M", "S"):
            return self.data_x.shape[-1]
        if self.features == "MS":
            return 1
        raise NotImplementedError

    @property
    def n_tokens_time(self):
        if self.freq == "h":
            return [13, 32, 7, 24]
        if self.freq == "t":
            return [13, 32, 7, 24, 4]
        raise NotImplementedError


class ETTHourDataset(InformerDataset):
    """ETTh1/ETTh2 fixed 12/4/4-month borders (`et.py:415-437`)."""

    def _borders(self, n: int):
        border1s = [0, 12 * 30 * 24 - self.seq_len,
                    12 * 30 * 24 + 4 * 30 * 24 - self.seq_len]
        border2s = [12 * 30 * 24, 12 * 30 * 24 + 4 * 30 * 24,
                    12 * 30 * 24 + 8 * 30 * 24]
        return border1s, border2s


class ETTMinuteDataset(InformerDataset):
    """ETTm1/ETTm2 15-minute cadence borders (`et.py:440-465`)."""

    def __init__(self, *args, freq: str = "t", **kwargs):
        super().__init__(*args, freq=freq, **kwargs)

    def _borders(self, n: int):
        border1s = [0, 12 * 30 * 24 * 4 - self.seq_len,
                    12 * 30 * 24 * 4 + 4 * 30 * 24 * 4 - self.seq_len]
        border2s = [12 * 30 * 24 * 4, 12 * 30 * 24 * 4 + 4 * 30 * 24 * 4,
                    12 * 30 * 24 * 4 + 8 * 30 * 24 * 4]
        return border1s, border2s
