"""Valohai dataset-version metadata sidecars (the port's own copy of the
JAX package's ``io/valohai_meta.py``, writing the same bytes).

Byte-parity reimplementation of the reference's artifact layer
(reference helpers.py:12-40): after saving model files, write a
``{file}.metadata.json`` next to each output declaring a dataset version
``dataset://llm-models/{project}_{exec_id}`` with a ``dev-{date}-model``
alias and ``['dev', 'llm']`` tags.  Run identity comes from
``/valohai/config/execution.json`` with the same local fallback
(``('test', unix-time)``, helpers.py:37-39).  The only deliberate change:
no dependency on the ``valohai`` package — ``valohai.outputs().path`` is
an identity transform when outputs are already written to the configured
output directory.
"""

from __future__ import annotations

import datetime
import json
import os
import time

EXECUTION_CONFIG_PATH = "/valohai/config/execution.json"


def get_run_identification(config_path: str = EXECUTION_CONFIG_PATH) -> tuple[str, str]:
    """(project_name, execution_id), with the reference's local fallback."""
    try:
        with open(config_path) as f:
            exec_details = json.load(f)
        project_name = exec_details["valohai.project-name"].split("/")[1]
        exec_id = exec_details["valohai.execution-id"]
    except FileNotFoundError:
        project_name = "test"
        exec_id = str(int(time.time()))
    return project_name, exec_id


def dataset_version_metadata(config_path: str = EXECUTION_CONFIG_PATH) -> dict:
    project_name, exec_id = get_run_identification(config_path)
    return {
        "valohai.dataset-versions": [
            {
                "uri": f"dataset://llm-models/{project_name}_{exec_id}",
                "targeting_aliases": [f"dev-{datetime.date.today()}-model"],
                "valohai.tags": ["dev", "llm"],
            },
        ],
    }


def save_valohai_metadata(output_dir: str, config_path: str = EXECUTION_CONFIG_PATH) -> list[str]:
    """Write a metadata sidecar for every file in ``output_dir``; returns the
    sidecar paths.  (The reference iterates ``os.listdir`` after
    ``save_pretrained``, helpers.py:24-28 — same here, skipping sidecars
    themselves so repeated calls don't stack ``.metadata.json.metadata.json``.)"""
    metadata = dataset_version_metadata(config_path)
    written = []
    for file in sorted(os.listdir(output_dir)):
        if file.endswith(".metadata.json"):
            continue
        md_path = os.path.join(output_dir, f"{file}.metadata.json")
        with open(md_path, "w") as outfile:
            json.dump(metadata, outfile)
        written.append(md_path)
    return written
