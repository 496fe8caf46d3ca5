# Save modeling results to text/CSV/JSON (port of rmt_tpu/io/save.py;
# reference: PyREMOT/library/saveResult.py:18-47, with configurable paths
# and a JSON writer for full dataPack round-trips).

from __future__ import annotations

import csv
import json
from typing import Any, Sequence

import numpy as np
import torch


def save_list_to_text(data: Sequence[Any], path: str = "saveFile.txt") -> str:
    with open(path, "w") as f:
        for element in data:
            f.write(str(element) + "\n")
    return path


def save_list_to_csv(data, header_list: Sequence[str], path: str = "saveFile.csv") -> str:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header_list)
        writer.writerows(np.asarray(data).tolist())
    return path


def _to_jsonable(obj):
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):  # on any device, grad or not
        return obj.detach().cpu().tolist()
    if hasattr(obj, "tolist"):  # numpy arrays and scalars
        return obj.tolist()
    return obj


def save_result_json(res: dict, path: str = "saveFile.json") -> str:
    """Serialize an rmtExe result (resModel/dataPack) to JSON."""
    with open(path, "w") as f:
        json.dump(_to_jsonable(res), f)
    return path
