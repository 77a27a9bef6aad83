"""Regex-based Solidity "AST" extraction and code2vec-style path building.

The port's copy of ``sct_gan_tpu/data/ast_parser.py``.

Behavioral parity with the reference pipeline (SCT-GAN/dataset.py:14-99, also
duplicated at SCT-GAN/inference.py:68-138): strip comments, normalize
whitespace, extract contract name / functions (name, params, returns) / state
variables via regex, then flatten into space-joined root-to-leaf paths.

This runs on the host (pure Python) and feeds the tokenize/pad/mask pipeline.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

_CONTRACT_RE = re.compile(r"contract\s+(\w+)")
_FUNCTION_RE = re.compile(
    r"function\s+(\w+)\s*\(([^)]*)\)\s*"
    r"(?:public|private|internal|external)?\s*"
    r"(?:view|pure|payable)?\s*"
    r"(?:returns\s*\(([^)]*)\))?\s*{"
)
_STATE_VAR_RE = re.compile(r"(?:uint|address|string|bool|mapping)\s+(?:\w+)\s+(\w+)")
_COMMENT_RE = re.compile(r"//.*?\n|/\*.*?\*/")
_WS_RE = re.compile(r"\s+")


def parse_solidity_to_ast(code: str) -> Optional[Dict[str, Any]]:
    """Parse Solidity source into the reference's simplified AST dict.

    Returns ``{'type': 'Contract', 'name', 'functions', 'variables'}`` or
    ``None`` on error (matching SCT-GAN/dataset.py:50-60).
    """
    try:
        code = _COMMENT_RE.sub("", code)
        code = _WS_RE.sub(" ", code)

        contract_match = _CONTRACT_RE.search(code)
        contract_name = contract_match.group(1) if contract_match else "Unknown"

        functions: List[Dict[str, Any]] = []
        for match in _FUNCTION_RE.finditer(code):
            params = match.group(2).split(",") if match.group(2) else []
            returns = match.group(3).split(",") if match.group(3) else []
            functions.append({
                "name": match.group(1),
                "parameters": [p.strip() for p in params],
                "returns": [r.strip() for r in returns],
            })

        variables = [m.group(1) for m in _STATE_VAR_RE.finditer(code)]

        return {
            "type": "Contract",
            "name": contract_name,
            "functions": functions,
            "variables": variables,
        }
    except Exception as e:  # pragma: no cover - parity with reference fallback
        print(f"Error parsing code: {e}")
        return None


def prepare_code2vec_input(ast: Dict[str, Any]) -> List[str]:
    """Flatten the AST dict into space-joined token paths.

    Parity with SCT-GAN/dataset.py:62-99: for each function emit
    ``Contract func``, then ``Contract func param`` per parameter and
    ``Contract func ret`` per return; for each state variable emit
    ``Contract var``.
    """
    paths: List[str] = []
    if ast is None:
        return paths

    current_path: List[str] = []
    if "name" in ast:
        current_path.append(ast["name"])

    for func in ast.get("functions", []):
        func_path = current_path + [func["name"]]
        paths.append(" ".join(func_path))
        for param in func["parameters"]:
            paths.append(" ".join(func_path + [param]))
        for ret in func["returns"]:
            paths.append(" ".join(func_path + [ret]))

    for var in ast.get("variables", []):
        paths.append(" ".join(current_path + [var]))

    return paths
