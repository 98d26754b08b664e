"""The port's record loader against the JAX package's on the same files.

``data/dataset.py load_json_records``: the same records, the same
``ValueError`` for a file with no parseable record and for one that is
neither an array, JSONL nor a data wrapper, a non-object JSONL line skipped
and counted (``data_skipped_records`` with ``skipped`` and ``kept``), the
same ``data_retry`` events for transient ``OSError``s and no retry of a
permanent one; with the native loader (``native/``) and without it
(``DLLM_NATIVE_JSONL=0``).  The native loader: built by g++ from the port's
own source into the gitignored ``build/native/``; its records equal the
Python path's and the JAX loader's (escapes, blank lines, a missing final
newline, nested values, a one-line data wrapper, negative indexing);
lone surrogates and invalid UTF-8 rejected at parse; a malformed line
reported by its number; a failed build raises with g++'s message instead
of falling back."""

import json
import os
import time

import pytest

from distributed_llms_example_tpu import native as jax_native
from distributed_llms_example_tpu.data import dataset as jax_dataset
from distributed_llms_example_tpu_torch import native
from distributed_llms_example_tpu_torch.data import dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RECORDS = [
    {"dialogue": "plain ascii", "summary": "ok"},
    {"dialogue": 'quotes " and \\ backslash / slash', "summary": "\b\f\n\r\t controls"},
    {"dialogue": "unicode café 日本語", "summary": "astral \U0001f600 emoji"},
    {"dialogue": "numbers", "summary": "x", "id": 17, "score": -3.25e2, "ok": True, "meta": None},
    {"dialogue": "nested", "summary": "y", "tags": ["a", "b"], "extra": {"k": [1, 2]}},
    {},
]

# the three files of the repair, and the other layouts the loaders share
FILES = {
    "record_then_string": '{"dialogue": "d", "summary": "s"}\n"just a string"\n',
    "every_line_malformed": '{"dialogue": \n{oops\nnot json\n',
    "one_string_line": '"hello"\n',
    "jsonl": "".join(json.dumps(r) + "\n" for r in RECORDS),
    "escapes": '{"a": "tab\\there", "b": "\\u0041\\u00e9\\u65e5", "c": "\\ud83d\\ude00", '
               '"d": "sl\\/ash"}\n',
    "blank_lines_no_final_newline": '{"a": "1"}\n\n  \n{"a": "2"}',
    "bad_line_kept_others": '{"a": "ok"}\n{"a": nope}\n{"a": "also ok"}\n',
    "array": json.dumps(RECORDS),
    "array_of_strings": json.dumps(["p1", "p2"]),
    "one_line_data_wrapper": json.dumps({"data": RECORDS[:2]}) + "\n",
    "pretty_data_wrapper": json.dumps({"data": RECORDS[:2]}, indent=2),
    "pretty_single_object": json.dumps(RECORDS[1], indent=2),
    "leading_space": ' {"a": "1"}\n',
}


def _events(capsys, kind):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{") and json.loads(line).get("event") == kind]


def _load(load, path):
    try:
        return list(load(path))
    except Exception as e:  # the same error type and message, or the same records
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("native_on", ["1", "0"], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(FILES))
def test_loader_equals_jax(tmp_path, monkeypatch, capsys, name, native_on):
    """Every layout: the same records or the same error as the JAX loader,
    and the same ``data_skipped_records`` line (``skipped`` and ``kept``)."""
    monkeypatch.setenv("DLLM_NATIVE_JSONL", native_on)
    path = str(tmp_path / f"{name}.jsonl")
    with open(path, "w", encoding="utf-8") as f:
        f.write(FILES[name])
    capsys.readouterr()
    want = _load(jax_dataset.load_json_records, path)
    want_skips = _events(capsys, "data_skipped_records")
    got = _load(dataset.load_json_records, path)
    assert got == want
    assert _events(capsys, "data_skipped_records") == want_skips


@pytest.mark.parametrize("name,expect", [
    ("record_then_string", [{"dialogue": "d", "summary": "s"}]),
    ("every_line_malformed", ("ValueError", "no parseable JSON records")),
    ("one_string_line", ("ValueError", "not a JSON array, JSONL, or data-wrapper file")),
])
def test_the_three_faults_of_the_repair(tmp_path, capsys, name, expect):
    """The inputs on which the loader differed from the JAX one: a
    non-object line skipped and counted, and the two errors."""
    path = str(tmp_path / "f.jsonl")
    with open(path, "w") as f:
        f.write(FILES[name])
    got = _load(dataset.load_json_records, path)
    if isinstance(expect, tuple):
        assert got[0] == expect[0] and got[1].endswith(expect[1])
    else:
        assert got == expect
        (skip,) = _events(capsys, "data_skipped_records")
        assert (skip["skipped"], skip["kept"]) == (1, 1)


def test_transient_errors_retry_as_jax(tmp_path, monkeypatch, capsys):
    """Two transient ``OSError``s, then the read: the same ``data_retry``
    lines (attempt, capped backoff, error) as the JAX loader and the
    records; three more than the budget: the error re-raises."""
    path = str(tmp_path / "r.jsonl")
    with open(path, "w") as f:
        f.write(FILES["jsonl"])
    monkeypatch.setattr(time, "sleep", lambda s: None)
    runs = {}
    for side, mod in (("jax", jax_dataset), ("port", dataset)):
        real, fails = mod._read_json_records, [2]

        def flaky(p, real=real, fails=fails):
            if fails[0]:
                fails[0] -= 1
                raise OSError(5, "Input/output error (transient)")
            return real(p)

        monkeypatch.setattr(mod, "_read_json_records", flaky)
        capsys.readouterr()
        recs = list(mod.load_json_records(path, backoff_s=1.5))
        runs[side] = (recs, _events(capsys, "data_retry"))
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] == RECORDS
    assert [e["backoff_s"] for e in runs["port"][1]] == [1.5, 2.0]  # capped at 2 s

    def always(p):
        raise OSError(5, "Input/output error")

    monkeypatch.setattr(dataset, "_read_json_records", always)
    with pytest.raises(OSError):
        dataset.load_json_records(path, retries=1)
    assert len(_events(capsys, "data_retry")) == 1


@pytest.mark.parametrize("kind", ["missing", "directory"])
def test_permanent_errors_fail_at_once(tmp_path, capsys, kind):
    path = str(tmp_path / "nope.json") if kind == "missing" else str(tmp_path)
    errors = []
    for mod in (jax_dataset, dataset):
        with pytest.raises(OSError) as e:
            mod.load_json_records(path)
        errors.append(type(e.value))
    assert errors[0] is errors[1] and errors[0] in (FileNotFoundError, IsADirectoryError)
    assert not _events(capsys, "data_retry")


# ----------------------------------------------------------- the native loader

@pytest.fixture(scope="module")
def jsonl_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("jsonl") / "data.jsonl"
    p.write_text(FILES["jsonl"], encoding="utf-8")
    return str(p)


def test_native_loader_builds_into_build_native():
    assert native.available(), native.build_error()
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert os.path.relpath(so, REPO).split(os.sep)[:2] == ["build", "native"]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


@pytest.mark.parametrize("name", ["jsonl", "escapes", "blank_lines_no_final_newline"])
def test_native_equals_python_and_jax(tmp_path, monkeypatch, name):
    path = tmp_path / "n.jsonl"
    path.write_text(FILES[name], encoding="utf-8")
    got = native.load_jsonl(str(path))
    assert isinstance(got, native.JsonlRecords)
    assert list(got) == list(jax_native.load_jsonl(str(path)))
    monkeypatch.setenv("DLLM_NATIVE_JSONL", "0")
    python = dataset.load_json_records(str(path))
    assert not isinstance(python, native.JsonlRecords)
    assert list(got) == list(python)


def test_jsonl_goes_through_the_native_loader(jsonl_file):
    recs = dataset.load_json_records(jsonl_file)
    assert isinstance(recs, native.JsonlRecords)
    assert list(recs) == RECORDS
    assert recs[-1] == RECORDS[-1] and recs[1:3] == RECORDS[1:3]
    with pytest.raises(IndexError):
        recs[-len(RECORDS) - 1]


@pytest.mark.parametrize("payload,match", [
    ('{"a": "bad \\ud800"}\n'.encode(), "surrogate"),
    ('{"a": "bad \\udc00"}\n'.encode(), "surrogate"),
    (b'{"a": "caf\xe9"}\n', "UTF-8"),
    (b'{"a": "ok"}\n{"a": nope}\n', "line 2"),
])
def test_native_rejects_at_parse(tmp_path, payload, match):
    """Lone surrogates and invalid UTF-8 fail at load time (so the Python
    path can still take the file), and a malformed line is named."""
    path = tmp_path / "bad.jsonl"
    path.write_bytes(payload)
    with pytest.raises(ValueError, match=match):
        native.load_jsonl(str(path))
    with pytest.raises(ValueError, match=match):
        jax_native.load_jsonl(str(path))


def test_failed_build_raises_with_gcc_message(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ rejects leaves ``available()``
    False, ``build_error()`` naming g++'s message, and ``load_jsonl`` (so
    ``load_json_records`` of a JSONL file) raising it; the opt-out reads
    the file in Python without starting a build."""
    src = tmp_path / "broken.cc"
    src.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    path = tmp_path / "d.jsonl"
    path.write_text(FILES["jsonl"])
    assert not native.available()
    assert "g++ failed" in native.build_error() and "error" in native.build_error()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        dataset.load_json_records(str(path))
    monkeypatch.setenv("DLLM_NATIVE_JSONL", "0")
    monkeypatch.setattr(native, "_load_lib", lambda: pytest.fail("the opt-out built"))
    assert list(dataset.load_json_records(str(path))) == RECORDS
