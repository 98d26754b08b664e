"""ROUGE-1/2/L/Lsum with a Porter stemmer, no network and no extra
dependencies (the port's own copy of the JAX package's
``evaluation/rouge.py``; pure Python).

The reference scores its eval pass with ``evaluate.load("rouge")`` and
``metric.compute(use_stemmer=True)``, which downloads google-research's
``rouge_score`` at run time.  This is a self-contained reimplementation
with the same semantics: lowercase, ``[a-z0-9]+`` tokenization, optional
Porter stemming (of tokens longer than 3 characters, as rouge_score
does), F1 scores, and newline-split union-LCS for rougeLsum.  Scores are
fractions in [0, 1].
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Iterable, Sequence

_TOKEN_RE = re.compile(r"[a-z0-9]+")

_VOWELS = "aeiou"


def _is_consonant(word: str, i: int) -> bool:
    ch = word[i]
    if ch in _VOWELS:
        return False
    if ch == "y":
        return i == 0 or not _is_consonant(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Porter's m: number of VC sequences."""
    m = 0
    prev_vowel = False
    for i in range(len(stem)):
        vowel = not _is_consonant(stem, i)
        if not vowel and prev_vowel:
            m += 1
        prev_vowel = vowel
    return m


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return len(word) >= 2 and word[-1] == word[-2] and _is_consonant(word, len(word) - 1)


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (
        _is_consonant(word, len(word) - 3)
        and not _is_consonant(word, len(word) - 2)
        and _is_consonant(word, len(word) - 1)
        and word[-1] not in "wxy"
    )


def porter_stem(word: str) -> str:
    """The classic Porter (1980) stemming algorithm."""
    w = word
    if len(w) <= 2:
        return w

    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]

    # step 1b
    flag_1b = False
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif w.endswith("ed"):
        if _contains_vowel(w[:-2]):
            w = w[:-2]
            flag_1b = True
    elif w.endswith("ing"):
        if _contains_vowel(w[:-3]):
            w = w[:-3]
            flag_1b = True
    if flag_1b:
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_consonant(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"

    # step 1c
    if w.endswith("y") and _contains_vowel(w[:-1]):
        w = w[:-1] + "i"

    # step 2
    step2 = [
        ("ational", "ate"), ("tional", "tion"), ("enci", "ence"), ("anci", "ance"),
        ("izer", "ize"), ("abli", "able"), ("alli", "al"), ("entli", "ent"),
        ("eli", "e"), ("ousli", "ous"), ("ization", "ize"), ("ation", "ate"),
        ("ator", "ate"), ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
        ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"), ("biliti", "ble"),
    ]
    for suf, rep in step2:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 3
    step3 = [
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""),
    ]
    for suf, rep in step3:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if _measure(stem) > 0:
                w = stem + rep
            break

    # step 4
    step4 = [
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent", "ion", "ou", "ism", "ate", "iti", "ous", "ive", "ize",
    ]
    for suf in step4:
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if suf == "ion" and not stem.endswith(("s", "t")):
                continue
            if _measure(stem) > 1:
                w = stem
            break

    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_consonant(w) and w.endswith("l"):
        w = w[:-1]
    return w


def tokenize(text: str, use_stemmer: bool = True) -> list[str]:
    toks = _TOKEN_RE.findall(text.lower())
    if use_stemmer:
        # rouge_score only stems tokens longer than 3 chars
        toks = [porter_stem(t) if len(t) > 3 else t for t in toks]
    return toks


def _f1(match: int, pred: int, ref: int) -> float:
    if pred == 0 or ref == 0:
        return 0.0
    p = match / pred
    r = match / ref
    return 2 * p * r / (p + r) if p + r else 0.0


def rouge_n(pred: Sequence[str], ref: Sequence[str], n: int) -> float:
    if len(pred) < n or len(ref) < n:
        return 0.0
    pc = Counter(tuple(pred[i : i + n]) for i in range(len(pred) - n + 1))
    rc = Counter(tuple(ref[i : i + n]) for i in range(len(ref) - n + 1))
    match = sum((pc & rc).values())
    return _f1(match, sum(pc.values()), sum(rc.values()))


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            cur[j] = prev[j - 1] + 1 if ai == b[j - 1] else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def rouge_l(pred: Sequence[str], ref: Sequence[str]) -> float:
    return _f1(_lcs_len(pred, ref), len(pred), len(ref))


def _union_lcs(pred_sents: list[list[str]], ref_sent: list[str]) -> set[tuple[int, str]]:
    """Positions (as (index, token)) of ref_sent covered by any pred sentence's LCS."""
    hit: set[int] = set()
    for ps in pred_sents:
        # recover one LCS alignment against ref_sent
        la, lb = len(ps), len(ref_sent)
        if not la or not lb:
            continue
        dp = [[0] * (lb + 1) for _ in range(la + 1)]
        for i in range(1, la + 1):
            for j in range(1, lb + 1):
                dp[i][j] = dp[i - 1][j - 1] + 1 if ps[i - 1] == ref_sent[j - 1] else max(dp[i - 1][j], dp[i][j - 1])
        i, j = la, lb
        while i > 0 and j > 0:
            if ps[i - 1] == ref_sent[j - 1]:
                hit.add(j - 1)
                i -= 1
                j -= 1
            elif dp[i - 1][j] >= dp[i][j - 1]:
                i -= 1
            else:
                j -= 1
    return {(j, ref_sent[j]) for j in hit}


def rouge_lsum(pred: str, ref: str, use_stemmer: bool = True) -> float:
    pred_sents = [tokenize(s, use_stemmer) for s in pred.splitlines() if s.strip()]
    ref_sents = [tokenize(s, use_stemmer) for s in ref.splitlines() if s.strip()]
    ref_total = sum(len(s) for s in ref_sents)
    pred_total = sum(len(s) for s in pred_sents)
    match = sum(len(_union_lcs(pred_sents, rs)) for rs in ref_sents)
    return _f1(match, pred_total, ref_total)


DEFAULT_TYPES = ("rouge1", "rouge2", "rougeL", "rougeLsum")


def compute(
    predictions: Iterable[str],
    references: Iterable[str],
    rouge_types: Sequence[str] = DEFAULT_TYPES,
    use_stemmer: bool = True,
) -> dict[str, float]:
    """Mean F1 per type over example pairs (fractions in [0,1])."""
    sums = {t: 0.0 for t in rouge_types}
    n = 0
    for pred, ref in zip(predictions, references):
        pt, rt = tokenize(pred, use_stemmer), tokenize(ref, use_stemmer)
        for t in rouge_types:
            if t == "rouge1":
                sums[t] += rouge_n(pt, rt, 1)
            elif t == "rouge2":
                sums[t] += rouge_n(pt, rt, 2)
            elif t == "rougeL":
                sums[t] += rouge_l(pt, rt)
            elif t == "rougeLsum":
                sums[t] += rouge_lsum(pred, ref, use_stemmer)
            else:
                raise ValueError(f"unknown rouge type {t!r}")
        n += 1
    if n == 0:
        return {t: 0.0 for t in rouge_types}
    return {t: s / n for t, s in sums.items()}
