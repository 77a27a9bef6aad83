"""Regex pattern bank for weak vulnerability supervision.

The port's copy of ``sct_gan_tpu/data/pattern_matcher.py`` (re and numpy).

Behavioral parity with MultiClass-TASC-model/pattern_matcher.py:5-200: four
vulnerability families with twelve sub-patterns, line-number match extraction,
``min(1, 0.5 * matches)`` scoring, textual explanations, and a dense-array
export for weak-label training (numpy instead of torch tensors).
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np


class PatternMatcher:
    def __init__(self):
        self.patterns = {
            "timestamp_dependence": {
                "TDInvocation": [
                    r"block\.timestamp",
                    r"now\s*[=<>]",
                    r"block\.timestamp\s*[=<>]",
                ],
                "TDAssign": [
                    r"block\.timestamp\s*=\s*[^;]+",
                    r"now\s*=\s*[^;]+",
                ],
                "TDContaminate": [
                    r"block\.timestamp\s*[+\-*/]\s*[^;]+",
                    r"now\s*[+\-*/]\s*[^;]+",
                ],
            },
            "reentrancy": {
                "callValueInvocation": [
                    r"\.call\s*\(\s*[^)]*value\s*:",
                    r"\.send\s*\(",
                    r"\.transfer\s*\(",
                ],
                "balanceDeduction": [
                    r"balance\s*-=\s*[^;]+",
                    r"balance\s*=\s*balance\s*-\s*[^;]+",
                ],
                "zeroParameter": [
                    r"require\s*\(\s*[^)]*==\s*0\s*\)",
                    r"if\s*\(\s*[^)]*==\s*0\s*\)",
                ],
                "ModifierConstrain": [
                    r"modifier\s+\w+\s*{[^}]*require\s*\([^)]*\)[^}]*}",
                ],
            },
            "integer_overflow": {
                "arithmeticOperation": [
                    r"[a-zA-Z_]\w*\s*[+\-*/]\s*[^;]+",
                    r"[0-9]+\s*[+\-*/]\s*[^;]+",
                ],
                "safeLibraryInvocation": [
                    r"SafeMath\.(add|sub|mul|div)",
                    r"using\s+SafeMath\s+for\s+uint",
                ],
                "conditionDeclaration": [
                    r"require\s*\(\s*[^)]*[<>]=?\s*[^)]*\)",
                    r"if\s*\(\s*[^)]*[<>]=?\s*[^)]*\)",
                ],
            },
            "dangerous_delegatecall": {
                "delegateInvocation": [
                    r"\.delegatecall\s*\(",
                    r"\.call\s*\(\s*[^)]*delegate\s*:",
                ],
                "ownerInvocation": [
                    r"require\s*\(\s*msg\.sender\s*==\s*owner\s*\)",
                    r"modifier\s+\w+\s*{[^}]*require\s*\(\s*msg\.sender\s*==\s*owner\s*\)[^}]*}",
                ],
            },
        }
        self.compiled_patterns = {
            vt: {name: [re.compile(p) for p in pats]
                 for name, pats in d.items()}
            for vt, d in self.patterns.items()
        }

    def match_patterns(self, code: str) -> Dict[str, Dict[str, List[Tuple[int, str]]]]:
        """Per-line regex matches: {vuln_type: {pattern: [(line#, text)]}}
        (1-based line numbers, parity with pattern_matcher.py:77-103)."""
        matches = {vt: {name: [] for name in d} for vt, d in self.patterns.items()}
        for line_num, line in enumerate(code.split("\n"), 1):
            for vt, d in self.compiled_patterns.items():
                for name, pats in d.items():
                    for pat in pats:
                        for m in pat.finditer(line):
                            matches[vt][name].append((line_num, m.group()))
        return matches

    def get_pattern_scores(self, code: str) -> Dict[str, Dict[str, float]]:
        """Score = min(1, 0.5 * match_count) (parity :105-120)."""
        matches = self.match_patterns(code)
        return {vt: {name: min(1.0, len(ms) * 0.5) for name, ms in d.items()}
                for vt, d in matches.items()}

    def get_vulnerability_explanation(self, code: str) -> List[str]:
        """Rule-based textual explanations with line citations (:122-168)."""
        m = self.match_patterns(code)
        out: List[str] = []
        td = m["timestamp_dependence"]
        if td["TDInvocation"] and (td["TDAssign"] or td["TDContaminate"]):
            out.append(
                "Timestamp Dependence: Block timestamp is used in critical "
                "operations. Found at lines: "
                + ", ".join(str(l) for l, _ in td["TDInvocation"]))
        re_ = m["reentrancy"]
        if (re_["callValueInvocation"] and re_["balanceDeduction"]
                and re_["zeroParameter"] and not re_["ModifierConstrain"]):
            out.append(
                "Reentrancy: Unsafe call.value usage without proper balance "
                "deduction. Found at lines: "
                + ", ".join(str(l) for l, _ in re_["callValueInvocation"]))
        io = m["integer_overflow"]
        if (io["arithmeticOperation"] and not io["safeLibraryInvocation"]
                and not io["conditionDeclaration"]):
            out.append(
                "Integer Overflow: Arithmetic operations without safety "
                "checks. Found at lines: "
                + ", ".join(str(l) for l, _ in io["arithmeticOperation"]))
        dd = m["dangerous_delegatecall"]
        if dd["delegateInvocation"] and not dd["ownerInvocation"]:
            out.append(
                "Dangerous Delegatecall: Unauthorized delegatecall usage. "
                "Found at lines: "
                + ", ".join(str(l) for l, _ in dd["delegateInvocation"]))
        return out

    def get_pattern_tensor(self, code: str) -> Dict[str, np.ndarray]:
        """Dense per-family score vectors for weak supervision (:170-200)."""
        s = self.get_pattern_scores(code)
        return {
            "timestamp_dependence": np.asarray(
                [s["timestamp_dependence"]["TDInvocation"],
                 s["timestamp_dependence"]["TDAssign"],
                 s["timestamp_dependence"]["TDContaminate"]], dtype=np.float32),
            "reentrancy": np.asarray(
                [s["reentrancy"]["callValueInvocation"],
                 s["reentrancy"]["balanceDeduction"],
                 s["reentrancy"]["zeroParameter"],
                 s["reentrancy"]["ModifierConstrain"]], dtype=np.float32),
            "integer_overflow": np.asarray(
                [s["integer_overflow"]["arithmeticOperation"],
                 s["integer_overflow"]["safeLibraryInvocation"],
                 s["integer_overflow"]["conditionDeclaration"]], dtype=np.float32),
            "dangerous_delegatecall": np.asarray(
                [s["dangerous_delegatecall"]["delegateInvocation"],
                 s["dangerous_delegatecall"]["ownerInvocation"]], dtype=np.float32),
        }
