"""Chinese word segmentation: dictionary DAG + HMM Viterbi for OOV.

Counterpart: ``alink_tpu/operator/common/nlp/segment.py`` (the
re-design of the reference's common/nlp/jiebasegment/: a max-probability
path over the dictionary DAG, then a BMES Viterbi over the runs of single
characters that are not a dictionary word). Host code, copied whole: the
same dictionary (the port's own copy, ``zh_dict.txt`` beside this file),
the same HMM estimated from it (``_Hmm``: damped dictionary frequencies,
``FREQ_DAMP`` 0.8; unseen pairs at ``_FLOOR``) and the same cuts, so the
tokens equal the JAX package's.

Pipeline per CJK run (reference Jieba.sentenceProcess):
  1. max-log-probability path over the in-dictionary DAG;
  2. maximal runs of consecutive single-char pieces whose concatenation
     is not a dictionary word are re-segmented by the BMES Viterbi;
  3. latin/digit runs pass through whole.
"""

from __future__ import annotations

import math
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ....common.params import ParamInfo
from .text import TokenizerMapper

_DICT_PATH = os.path.join(os.path.dirname(__file__), "zh_dict.txt")

_CJK = re.compile(r"[一-鿿]+")
_NON_CJK_TOKEN = re.compile(r"[a-zA-Z0-9_]+|[^\s一-鿿]")

# BMES state ids
_B, _M, _E, _S = 0, 1, 2, 3
_FLOOR = -18.0          # log-prob floor for unseen (state, char) pairs


@lru_cache(maxsize=1)
def _load_builtin() -> Dict[str, int]:
    freq: Dict[str, int] = {}
    with open(_DICT_PATH, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            w, _, c = line.partition(" ")
            freq[w] = int(c)
    return freq


class _Hmm:
    """BMES HMM with parameters estimated from a frequency dictionary
    (the original-data replacement for FinalSeg.java's prob_* resources)."""

    # HMM weights use DAMPED dict frequencies (f^0.8): the reference's
    # prob_emit was trained on a BMES-tagged corpus where boundary-char
    # statistics sit between TYPE and raw TOKEN frequencies; estimating
    # from raw per-entry bands lets a few ultra-common words drown the
    # open-class name/OOV chars (measured: growing the general vocabulary
    # 1.6k -> 9k broke OOV full-name gluing at power 1.0), while damping
    # too hard (<=0.7) starves the single-char S states and over-glues
    # function-word boundaries ("后 在" -> "后在"). 0.8 satisfies both
    # measured constraints.
    FREQ_DAMP = 0.8

    def __init__(self, freq: Dict[str, int]):
        emit = [dict() for _ in range(4)]       # state -> char -> weight
        trans = np.zeros((4, 4))
        start = np.zeros(4)
        multi_mass = 0.0
        single_mass = 0.0
        for w, f in freq.items():
            L = len(w)
            fw = float(f) ** self.FREQ_DAMP
            if L == 1:
                emit[_S][w] = emit[_S].get(w, 0.0) + fw
                single_mass += fw
                continue
            multi_mass += fw
            emit[_B][w[0]] = emit[_B].get(w[0], 0.0) + fw
            emit[_E][w[-1]] = emit[_E].get(w[-1], 0.0) + fw
            for c in w[1:-1]:
                emit[_M][c] = emit[_M].get(c, 0.0) + fw
            # word-internal transitions: B M^{L-2} E
            if L == 2:
                trans[_B, _E] += fw
            else:
                trans[_B, _M] += fw
                trans[_M, _M] += fw * (L - 3)
                trans[_M, _E] += fw
        # start probs and inter-word transitions from the freq mass split
        tot = max(multi_mass + single_mass, 1.0)
        start[_B] = multi_mass / tot
        start[_S] = single_mass / tot
        for prev in (_E, _S):                   # word boundary -> next word
            trans[prev, _B] = start[_B]
            trans[prev, _S] = start[_S]
        self.log_start = np.full(4, _FLOOR)
        for s in (_B, _S):
            if start[s] > 0:
                self.log_start[s] = math.log(start[s])
        self.log_trans = np.full((4, 4), _FLOOR)
        for i in range(4):
            row = trans[i].sum()
            if row > 0:
                for j in range(4):
                    if trans[i, j] > 0:
                        self.log_trans[i, j] = math.log(trans[i, j] / row)
        self.log_emit: List[Dict[str, float]] = []
        for s in range(4):
            total = sum(emit[s].values())
            if total <= 0:
                self.log_emit.append({})
                continue
            lt = math.log(total)
            self.log_emit.append(
                {c: math.log(v) - lt for c, v in emit[s].items()})

    def _e(self, state: int, char: str) -> float:
        return self.log_emit[state].get(char, _FLOOR)

    def cut(self, s: str) -> List[str]:
        """Viterbi BMES decode -> word pieces (FinalSeg.viterbi analogue)."""
        n = len(s)
        if n == 1:
            return [s]
        v = np.full((n, 4), -np.inf)
        back = np.zeros((n, 4), np.int8)
        for st in range(4):
            v[0, st] = self.log_start[st] + self._e(st, s[0])
        for i in range(1, n):
            for st in range(4):
                scores = v[i - 1] + self.log_trans[:, st]
                p = int(np.argmax(scores))
                v[i, st] = scores[p] + self._e(st, s[i])
                back[i, st] = p
        # last char must close a word: E or S
        last = _E if v[n - 1, _E] >= v[n - 1, _S] else _S
        states = [last]
        for i in range(n - 1, 0, -1):
            states.append(int(back[i, states[-1]]))
        states.reverse()
        out, w = [], s[0]
        for i in range(1, n):
            if states[i] in (_B, _S):
                out.append(w)
                w = s[i]
            else:
                w += s[i]
        out.append(w)
        return out


class SegmentDict:
    def __init__(self, extra_words: Optional[Sequence[str]] = None,
                 use_hmm: bool = True):
        self.freq: Dict[str, int] = dict(_load_builtin())
        for w in extra_words or []:
            self.freq[str(w)] = max(self.freq.get(str(w), 0), 1000)
        self.total = sum(self.freq.values())
        self.max_len = max((len(w) for w in self.freq), default=1)
        self.hmm = _Hmm(self.freq) if use_hmm else None

    def _dag_cut(self, s: str) -> List[str]:
        """Max-probability path over the in-dictionary DAG."""
        n = len(s)
        logtotal = math.log(self.total)
        # best[i] = (score, j) meaning s[i:j] starts the best path from i
        best: List[Tuple[float, int]] = [(float("-inf"), 0)] * (n + 1)
        best[n] = (0.0, n)
        for i in range(n - 1, -1, -1):
            cands = []
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                w = s[i:j]
                f = self.freq.get(w)
                if f is None and j > i + 1:
                    continue
                logp = (math.log(f) - logtotal) if f else (math.log(1) - logtotal - 10.0)
                cands.append((logp + best[j][0], j))
            best[i] = max(cands) if cands else (best[i + 1][0], i + 1)
        out, i = [], 0
        while i < n:
            j = best[i][1]
            out.append(s[i:j])
            i = j
        return out

    def cut_cjk(self, s: str, stats: Optional[Dict[str, int]] = None
                ) -> List[str]:
        """DAG cut, then HMM re-segmentation of single-char runs
        (reference Jieba.cutDAG buf + FinalSeg flow). ``stats`` (optional)
        accumulates {"tokens", "hmm_tokens"}: the share of tokens the
        Viterbi pass cut."""
        pieces = self._dag_cut(s)
        if self.hmm is None:
            if stats is not None:
                stats["tokens"] = stats.get("tokens", 0) + len(pieces)
            return pieces
        out: List[str] = []
        buf = ""
        for p in pieces:
            if len(p) == 1:
                buf += p
                continue
            out.extend(self._flush(buf, stats))
            buf = ""
            out.append(p)
        out.extend(self._flush(buf, stats))
        if stats is not None:
            stats["tokens"] = stats.get("tokens", 0) + len(out)
        return out

    def _flush(self, buf: str, stats: Optional[Dict[str, int]] = None
               ) -> List[str]:
        if not buf:
            return []
        if len(buf) == 1 or buf in self.freq:
            return [buf]
        toks = self.hmm.cut(buf)
        if stats is not None:
            stats["hmm_tokens"] = stats.get("hmm_tokens", 0) + len(toks)
        return toks

    def cut(self, text: str, stats: Optional[Dict[str, int]] = None
            ) -> List[str]:
        out: List[str] = []
        pos = 0
        for m in _CJK.finditer(text):
            for tok in _NON_CJK_TOKEN.findall(text[pos:m.start()]):
                out.append(tok)
            out.extend(self.cut_cjk(m.group(), stats))
            pos = m.end()
        for tok in _NON_CJK_TOKEN.findall(text[pos:]):
            out.append(tok)
        return out


class SegmentMapper(TokenizerMapper):
    """reference: nlp/SegmentMapper (jieba port) — space-joined tokens."""

    USER_DEFINED_DICT = ParamInfo("user_defined_dict", list, "extra dictionary words")

    def __init__(self, data_schema, params=None, **kwargs):
        super().__init__(data_schema, params, **kwargs)
        self._dict = SegmentDict(self.params._m.get("user_defined_dict"))

    def _map_text(self, s):
        if s is None:
            return None
        return " ".join(self._dict.cut(str(s)))
