"""Record loading for prompt files (the port's copy of the JAX package's
``load_json_records`` formats): a JSON array, JSONL, or a ``{"data": [...]}``
wrapper.  Malformed JSONL lines are skipped and counted in one
``data_skipped_records`` event."""

from __future__ import annotations

import json

from distributed_llms_example_tpu_torch.utils.jsonlog import log_json


def load_json_records(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read().lstrip()
    if text.startswith("["):
        return json.loads(text)
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None  # more than one document: JSONL
    if isinstance(doc, dict):
        return doc["data"] if isinstance(doc.get("data"), list) else [doc]
    records, skipped = [], 0
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            skipped += 1
            continue
        if isinstance(rec, (dict, str)):
            records.append(rec)
        else:
            skipped += 1
    if skipped:
        log_json({"event": "data_skipped_records", "path": path, "skipped": skipped})
    return records
