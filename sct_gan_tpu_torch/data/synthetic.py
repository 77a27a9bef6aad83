"""Synthetic labeled Solidity corpus for tests, training runs, and benches.

The port's copy of ``sct_gan_tpu/data/synthetic.py``: ``generate_corpus``,
``write_corpus_csv`` and the snippet builders they draw from. The CSV is
written with the standard ``csv`` module.

The reference trains on a private Etherscan CSV
(`contract_sources_with_vulnerabilities_2048_token_size.csv`, Model-v3
trainning-phase.ipynb cell 6) that is not part of the repo. This generator
produces contracts with known vulnerable lines per type so the full pipeline
(labels → training → detection → metrics) is exercisable hermetically. The
CSV schema matches the reference's: ``source_code``, ``contract_name``, and
one ``{vuln}_lines`` column per vulnerability type.

Detection on this corpus is deliberately NOT trivial: every vulnerability
type has several surface variants, every vulnerable pattern has a safe
"near-miss" twin that shares most of its tokens (checks-effects-interactions
withdraw vs reentrant withdraw, ``msg.sender`` auth vs ``tx.origin`` auth,
``transfer`` vs unchecked ``send``, bounded vs unbounded payout loops,
checked vs raw arithmetic), and identifiers are randomized per contract — so
a model must learn the semantic pattern, not memorize one snippet or one
variable name.
"""
from __future__ import annotations

import csv
import random
from typing import Dict, List, Optional, Sequence, Tuple

VULNERABILITY_TYPES = [
    "ARTHM", "DOS", "LE", "RENT", "TimeM", "TimeO", "Tx-Origin", "UE",
]

# Identifier pools drawn per contract, so no vuln type is tied to a name.
_FN_NAMES = ["process", "handle", "execute", "settle", "claim", "redeem",
             "update", "release", "collect", "sweep", "finalize", "sync"]
_AMT_NAMES = ["amount", "value", "sum", "qty", "wad", "units", "portion"]
_ADDR_NAMES = ["user", "account", "recipient", "beneficiary", "target",
               "payee"]


class _Names:
    """Per-contract random identifier supply (unique function names)."""

    def __init__(self, rng: random.Random):
        self.rng = rng
        self._fns = _FN_NAMES[:]
        rng.shuffle(self._fns)
        self._i = 0

    def fn(self) -> str:
        self._i += 1
        base = self._fns[self._i % len(self._fns)]
        return f"{base}{self._i}" if self._i > len(self._fns) else base

    def amt(self) -> str:
        return self.rng.choice(_AMT_NAMES)

    def addr(self) -> str:
        return self.rng.choice(_ADDR_NAMES)


# Snippet builders: nm -> (lines, relative_vulnerable_line_indices).
# Several variants per type; the matching safe near-miss twins live in
# _SAFE_BUILDERS and share most surface tokens with them.

def _arthm_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        total = total + {a} * rate;",
             "    }"], [1])


def _arthm_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        balances[msg.sender] = balances[msg.sender] - {a};",
             f"        total -= {a} * 2;",
             "    }"], [1, 2])


def _arthm_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(uint8 count) public {{",
             "        uint8 next = uint8(state) + count;",
             "        state = next;",
             "    }"], [1])


def _dos_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        for (uint i = 0; i < holders.length; i++) {",
             "            holders[i].transfer(dividend);",
             "        }",
             "    }"], [1, 2])


def _dos_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint i = 0;",
             "        while (i < holders.length) {",
             "            balances[holders[i]] += dividend;",
             "            i++;",
             "        }",
             "    }"], [2, 3])


def _le_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public payable {{",
             "        locked[msg.sender] = msg.value;",
             "    }"], [1])


def _le_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public payable {{",
             "        require(msg.value > 0);",
             "        locked[msg.sender] += msg.value;",
             "        state = 1;",
             "    }"], [2])


def _rent_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        msg.sender.call{{value: {a}}}(\"\");",
             f"        balances[msg.sender] -= {a};",
             "    }"], [1, 2])


def _rent_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        require(balances[msg.sender] >= {a});",
             f"        (bool ok, ) = msg.sender.call{{value: {a}}}(\"\");",
             "        require(ok);",
             f"        balances[msg.sender] = balances[msg.sender] - {a};",
             "    }"], [2, 4])


def _timem_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public view returns (bool) {{",
             "        return block.timestamp % 2 == 0;",
             "    }"], [1])


def _timem_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint256 roll = uint256(blockhash(block.number - 1)) % 100;",
             "        if (roll < 50) { dividend += 1; }",
             "    }"], [1])


def _timeo_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        if (now > deadline) { state = 2; }",
             "    }"], [1])


def _timeo_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(block.timestamp >= deadline + 30 seconds);",
             "        paused = true;",
             "    }"], [1])


def _txorigin_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(tx.origin == owner);",
             "        paused = true;",
             "    }"], [1])


def _txorigin_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f, ad = nm.fn(), nm.addr()
    return ([f"    function {f}(address {ad}) public {{",
             f"        if (tx.origin == {ad}) {{",
             "            state = 3;",
             "        }",
             "    }"], [1])


def _arthm_v3(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        uint256 fee = {a} * rate / 100;",
             "        total = total - fee;",
             "    }"], [1, 2])


def _dos_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        for (uint i = 0; i < holders.length; i++) {",
             "            if (!holders[i].send(dividend)) { revert(); }",
             "        }",
             "    }"], [1, 2])


def _le_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    return (["    fallback() external payable {",
             "        state = 7;",
             "    }"], [1])


def _rent_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        payable(msg.sender).call{{value: {a}}}(\"\");",
             f"        if (balances[msg.sender] >= {a}) {{ "
             f"balances[msg.sender] -= {a}; }}",
             "    }"], [1, 2])


def _timem_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        if (block.timestamp % 10 == 3) {",
             "            dividend = dividend + 1;",
             "        }",
             "    }"], [1])


def _timeo_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        if (block.timestamp == deadline) { dividend += 2; }",
             "    }"], [1])


def _txorigin_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(uint256 r) public {{",
             "        if (tx.origin != owner) { revert(); }",
             "        rate = r;",
             "    }"], [1])


def _ue_v2(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a, ad = nm.fn(), nm.amt(), nm.addr()
    return ([f"    function {f}(address payable {ad}, uint256 {a}) public {{",
             f"        {ad}.send({a});",
             f"        balances[{ad}] = 0;",
             "    }"], [1])


def _ue_v0(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a, ad = nm.fn(), nm.amt(), nm.addr()
    return ([f"    function {f}(address payable {ad}, uint256 {a}) public {{",
             f"        {ad}.send({a});",
             "    }"], [1])


def _ue_v1(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        owner.call{{value: {a}}}(\"\");",
             f"        total += {a};",
             "    }"], [1])


def _ue_v3(nm: _Names) -> Tuple[List[str], List[int]]:
    # bare low-level call with the return value dropped (no value transfer):
    # broadens family 0's UE coverage beyond send/call{value} so held-out
    # raw-call forms are a generalization step, not an unseen concept
    f = nm.fn()
    return ([f"    function {f}(address target, bytes memory payload) "
             "public {",
             "        target.call(payload);",
             "    }"], [1])


def _arthm_v4(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        rate += {a};",
             f"        deadline = deadline + rate * {a};",
             "    }"], [1, 2])


# -- family-1 variants: surface forms DISJOINT from the family-0 builders
# above. Corpus v2 trains on one family and evaluates on the other, so the
# line benchmark measures generalization to unseen templates instead of
# memorization (VERDICT r3: at 2,000 contracts the single-family corpus
# became fully separable and line PR-AUC pinned at 1.0).

def _arthm_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(address to, uint256 {a}) public {{",
             f"        balances[to] += {a};",
             f"        balances[msg.sender] -= {a};",
             "    }"], [1, 2])


def _arthm_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(uint256 factor) public {{",
             "        rate = rate * factor / 100;",
             "        total = total * rate;",
             "    }"], [1, 2])


def _dos_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        for (uint j = 0; j < holders.length; j++) {",
             "            require(holders[j].send(dividend));",
             "        }",
             "    }"], [1, 2])


def _dos_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(address payable[] memory winners) public {{",
             "        uint j = winners.length;",
             "        while (j > 0) {",
             "            j--;",
             "            winners[j].call{value: dividend}(\"\");",
             "        }",
             "    }"], [2, 4])


def _le_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() external payable {{",
             "        total += msg.value;",
             "    }",
             "    // no withdrawal path for accumulated ether"], [1])


def _le_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    receive() external payable {{",
             f"        locked[msg.sender] = locked[msg.sender] + msg.value;",
             "    }"], [1])


def _rent_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        _pay(payable(msg.sender), {a});",
             f"        balances[msg.sender] = 0;",
             "    }",
             f"    function _pay(address payable to, uint256 {a}) internal {{",
             f"        to.call{{value: {a}}}(\"\");",
             "    }"], [1, 2, 5])


def _rent_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint256 owed = balances[msg.sender];",
             "        (bool sent, ) = msg.sender.call{value: owed}(\"\");",
             "        if (sent) { balances[msg.sender] = 0; }",
             "    }"], [2, 3])


def _timem_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint256 lucky = uint256(keccak256(abi.encodePacked("
             "block.timestamp, msg.sender))) % 10;",
             "        if (lucky == 7) { balances[msg.sender] += dividend; }",
             "    }"], [1])


def _timem_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public view returns (uint256) {{",
             "        return uint256(blockhash(block.number)) % holders.length;",
             "    }"], [1])


def _timeo_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        if (block.number > deadline) {",
             "            paused = true;",
             "        }",
             "    }"], [1])


def _timeo_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(now >= deadline);",
             "        state = state + 1;",
             "    }"], [1])


def _txorigin_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    return (["    modifier onlyEOAOwner() {",
             "        require(tx.origin == owner);",
             "        _;",
             "    }"], [1])


def _txorigin_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        payable(tx.origin).transfer({a});",
             "    }"], [1])


def _ue_f1a(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(address token, address to, uint256 {a}) "
             "public {",
             "        token.call(abi.encodeWithSignature("
             f"\"transfer(address,uint256)\", to, {a}));",
             "    }"], [1])


def _ue_f1b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(address impl, bytes memory data) public {{",
             "        impl.delegatecall(data);",
             "    }"], [1])


def _arthm_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}) public {{",
             f"        unchecked {{ balances[msg.sender] += {a} * rate; }}",
             "    }"], [1])


def _dos_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint n = holders.length;",
             "        for (uint k = 0; k < n; k++) {",
             "            payable(holders[k]).transfer(balances[holders[k]]);",
             "        }",
             "    }"], [2, 3])


def _le_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public payable {{",
             "        require(msg.value >= rate);",
             "        total = total + msg.value;",
             "    }"], [2])


def _rent_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(!paused);",
             "        uint256 bal = locked[msg.sender];",
             "        (bool done, ) = payable(msg.sender).call{value: bal}"
             "(\"\");",
             "        locked[msg.sender] = locked[msg.sender] - bal;",
             "        require(done);",
             "    }"], [3, 4])


def _timem_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public view returns (uint256) {{",
             "        return uint256(keccak256(abi.encodePacked("
             "block.number, block.timestamp))) % 6;",
             "    }"], [1])


def _timeo_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(block.number >= deadline);",
             "        state = 9;",
             "    }"], [1])


def _txorigin_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        address caller = tx.origin;",
             "        require(caller == owner);",
             "        state = 8;",
             "    }"], [1, 2])


def _ue_f1c(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}(address impl) public {{",
             "        impl.delegatecall(abi.encodeWithSignature(\"sync()\"));",
             "    }"], [1])


def _ue_f1d(nm: _Names) -> Tuple[List[str], List[int]]:
    # unchecked .send of the full contract balance: gives family 1 a send-
    # based UE surface (family 0's dominant form is send-with-amount), so the
    # fam1->fam0 direction faces a template gap, not a concept gap
    f, ad = nm.fn(), nm.addr()
    return ([f"    function {f}(address payable {ad}) public {{",
             f"        {ad}.send(address(this).balance);",
             "    }"], [1])


def _arthm_f1d(nm: _Names) -> Tuple[List[str], List[int]]:
    # narrow-int cast arithmetic in family-1 surface form (family 0's _v2
    # covers the concept with a different template)
    f = nm.fn()
    return ([f"    function {f}(uint8 n) public {{",
             "        uint8 idx = uint8(holders.length) + n;",
             "        state = idx * 2;",
             "    }"], [1, 2])


# -- family-2 variants (round 5): a third disjoint family that NO training
# direction ever sees — the pure-generalization column of the cross-family
# matrix (VERDICT r4 item 5).

def _arthm_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        state = state - 1;",
             "    }"], [1])


def _arthm_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(uint256 {a}, uint256 t) public {{",
             f"        uint256 interest = {a} * rate * t;",
             "        balances[msg.sender] += interest;",
             "    }"], [1, 2])


def _dos_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        for (uint i = 0; i < holders.length; i++) {",
             "            delete balances[holders[i]];",
             "        }",
             "    }"], [1, 2])


def _dos_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint i = holders.length;",
             "        do {",
             "            i--;",
             "            holders[i].transfer(locked[holders[i]]);",
             "        } while (i > 0);",
             "    }"], [2, 4])


def _le_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() external payable {{",
             "        locked[msg.sender] = 1;",
             "    }"], [1])


def _le_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public payable {{",
             "        emit Deposit(msg.sender, msg.value);",
             "    }"], [1])


def _rent_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint256 p = balances[msg.sender];",
             "        if (p > 0) {",
             "            msg.sender.call{value: p}(\"\");",
             "            balances[msg.sender] = 0;",
             "        }",
             "    }"], [3, 4])


def _rent_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f, ad = nm.fn(), nm.addr()
    return ([f"    function {f}(address payable {ad}) public {{",
             f"        {ad}.call{{value: dividend}}(\"\");",
             f"        locked[{ad}] = block.number;",
             "    }"], [1, 2])


def _timem_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        uint256 seed = block.timestamp ^ "
             "uint256(uint160(msg.sender));",
             "        if (seed % 3 == 0) { balances[msg.sender] += 1; }",
             "    }"], [1, 2])


def _timem_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public view returns (bool) {{",
             "        return blockhash(block.number - 2) == "
             "blockhash(block.number - 1);",
             "    }"], [1])


def _timeo_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        if (now >= deadline && !paused) {",
             "            paused = true;",
             "        }",
             "    }"], [1])


def _timeo_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(block.number % 256 == 0);",
             "        dividend = 0;",
             "    }"], [1])


def _txorigin_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        require(tx.origin == msg.sender && tx.origin == owner);",
             "        paused = false;",
             "    }"], [1])


def _txorigin_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f = nm.fn()
    return ([f"    function {f}() public {{",
             "        owner = tx.origin;",
             "    }"], [1])


def _ue_f2a(nm: _Names) -> Tuple[List[str], List[int]]:
    f, ad = nm.fn(), nm.addr()
    return ([f"    function {f}(address payable {ad}) public {{",
             f"        {ad}.call{{gas: 2300, value: dividend}}(\"\");",
             "    }"], [1])


def _ue_f2b(nm: _Names) -> Tuple[List[str], List[int]]:
    f, a = nm.fn(), nm.amt()
    return ([f"    function {f}(address token, uint256 {a}) public {{",
             f"        token.call(abi.encodePacked(bytes4(0xa9059cbb), {a}));",
             "    }"], [1])


# builder -> template family (0, 1, or 2); corpus v2 keeps the families
# disjoint between train and eval splits
_VULN_BUILDERS: Dict[str, Sequence] = {
    "ARTHM": (_arthm_v0, _arthm_v1, _arthm_v2, _arthm_v3, _arthm_v4),
    "DOS": (_dos_v0, _dos_v1, _dos_v2),
    "LE": (_le_v0, _le_v1, _le_v2),
    "RENT": (_rent_v0, _rent_v1, _rent_v2),
    "TimeM": (_timem_v0, _timem_v1, _timem_v2),
    "TimeO": (_timeo_v0, _timeo_v1, _timeo_v2),
    "Tx-Origin": (_txorigin_v0, _txorigin_v1, _txorigin_v2),
    "UE": (_ue_v0, _ue_v1, _ue_v2, _ue_v3),
}

_VULN_BUILDERS_F1: Dict[str, Sequence] = {
    "ARTHM": (_arthm_f1a, _arthm_f1b, _arthm_f1c, _arthm_f1d),
    "DOS": (_dos_f1a, _dos_f1b, _dos_f1c),
    "LE": (_le_f1a, _le_f1b, _le_f1c),
    "RENT": (_rent_f1a, _rent_f1b, _rent_f1c),
    "TimeM": (_timem_f1a, _timem_f1b, _timem_f1c),
    "TimeO": (_timeo_f1a, _timeo_f1b, _timeo_f1c),
    "Tx-Origin": (_txorigin_f1a, _txorigin_f1b, _txorigin_f1c),
    "UE": (_ue_f1a, _ue_f1b, _ue_f1c, _ue_f1d),
}

_VULN_BUILDERS_F2: Dict[str, Sequence] = {
    "ARTHM": (_arthm_f2a, _arthm_f2b),
    "DOS": (_dos_f2a, _dos_f2b),
    "LE": (_le_f2a, _le_f2b),
    "RENT": (_rent_f2a, _rent_f2b),
    "TimeM": (_timem_f2a, _timem_f2b),
    "TimeO": (_timeo_f2a, _timeo_f2b),
    "Tx-Origin": (_txorigin_f2a, _txorigin_f2b),
    "UE": (_ue_f2a, _ue_f2b),
}

_FAMILIES = {0: _VULN_BUILDERS, 1: _VULN_BUILDERS_F1, 2: _VULN_BUILDERS_F2}


# Safe snippets, including near-miss twins of every vulnerable pattern.

def _safe_view(nm: _Names) -> List[str]:
    f = nm.fn()
    return [f"    function {f}() public view returns (address) {{",
            "        return owner;",
            "    }"]


def _safe_auth(nm: _Names) -> List[str]:
    # msg.sender auth — the safe twin of the tx.origin pattern
    f = nm.fn()
    return [f"    function {f}(uint256 r) public {{",
            "        require(msg.sender == owner);",
            "        rate = r;",
            "    }"]


def _safe_withdraw(nm: _Names) -> List[str]:
    # checks-effects-interactions — the safe twin of RENT
    f, a = nm.fn(), nm.amt()
    return [f"    function {f}(uint256 {a}) public {{",
            f"        require(balances[msg.sender] >= {a});",
            f"        balances[msg.sender] -= {a};",
            f"        (bool ok, ) = msg.sender.call{{value: {a}}}(\"\");",
            "        require(ok);",
            "    }"]


def _safe_transfer(nm: _Names) -> List[str]:
    # checked transfer — the safe twin of unchecked send (UE)
    f, a, ad = nm.fn(), nm.amt(), nm.addr()
    return [f"    function {f}(address payable {ad}, uint256 {a}) public {{",
            "        require(msg.sender == owner);",
            f"        {ad}.transfer({a});",
            "    }"]


def _safe_bounded_loop(nm: _Names) -> List[str]:
    # bounded, pull-style accounting — the safe twin of the DOS loops
    f = nm.fn()
    return [f"    function {f}(uint start, uint end) public {{",
            "        require(end - start <= 50);",
            "        for (uint i = start; i < end; i++) {",
            "            balances[holders[i]] += dividend;",
            "        }",
            "    }"]


def _safe_checked_math(nm: _Names) -> List[str]:
    # overflow-guarded arithmetic — the safe twin of ARTHM
    f, a = nm.fn(), nm.amt()
    return [f"    function {f}(uint256 {a}) public {{",
            f"        uint256 next = total + {a};",
            f"        require(next >= total);",
            "        total = next;",
            "    }"]


def _safe_deadline_view(nm: _Names) -> List[str]:
    # reading a timestamp for display only — near-miss of TimeM/TimeO
    f = nm.fn()
    return [f"    function {f}() public view returns (uint256) {{",
            "        return deadline;",
            "    }"]


def _safe_event(nm: _Names) -> List[str]:
    return ["    event Deposit(address indexed from, uint256 amount);"]


def _safe_pure(nm: _Names) -> List[str]:
    f = nm.fn()
    return [f"    function {f}() public pure returns (uint256) {{",
            "        return 1;",
            "    }"]


def _safe_checked_call(nm: _Names) -> List[str]:
    # low-level call with the result REQUIRE-checked — the safe twin of the
    # raw-call UE variants
    f = nm.fn()
    return [f"    function {f}(address target, bytes memory payload) "
            "public {",
            "        require(msg.sender == owner);",
            "        (bool ok, ) = target.call(payload);",
            "        require(ok);",
            "    }"]


_SAFE_BUILDERS = [_safe_view, _safe_auth, _safe_withdraw, _safe_transfer,
                  _safe_bounded_loop, _safe_checked_math, _safe_deadline_view,
                  _safe_event, _safe_pure, _safe_checked_call]


# -- near-miss DISTRACTORS (corpus v2): vulnerable-looking token sequences
# placed where they are inert — comments, string literals, dead code — plus
# cross-type confusers. All label 0: a model keying on surface tokens alone
# scores false positives on every one of these.

def _distractor_comment(nm: _Names) -> List[str]:
    return ["    // audit note: tx.origin == owner checks are phishable;",
            "    // msg.sender.call{value: amount}(\"\") before the state",
            "    // write would reenter — keep checks-effects-interactions."]


def _distractor_commented_code(nm: _Names) -> List[str]:
    a = nm.amt()
    return ["    /*",
            f"    total = total + {a} * rate;",
            f"    msg.sender.call{{value: {a}}}(\"\");",
            f"    balances[msg.sender] -= {a};",
            "    */"]


def _distractor_string(nm: _Names) -> List[str]:
    f = nm.fn()
    return [f"    function {f}() public pure returns (string memory) {{",
            "        return \"never use block.timestamp % 2 for randomness\";",
            "    }"]


def _distractor_dead_code(nm: _Names) -> List[str]:
    f, a = nm.fn(), nm.amt()
    return [f"    function {f}(uint256 {a}) public {{",
            "        if (false) {",
            f"            owner.call{{value: {a}}}(\"\");",
            f"            total -= {a} * 2;",
            "        }",
            "        state = 4;",
            "    }"]


def _distractor_safe_timestamp(nm: _Names) -> List[str]:
    # cross-type confuser: block.timestamp recorded for bookkeeping only
    f = nm.fn()
    return [f"    function {f}() public {{",
            "        locked[msg.sender] = block.timestamp;",
            "        emit Deposit(msg.sender, 0);",
            "    }"]


def _distractor_safe_loop_call(nm: _Names) -> List[str]:
    # bounded loop over a CALLDATA array with checked sends: shares the
    # for/transfer surface of DOS without the unbounded-storage-array hazard
    f = nm.fn()
    return [f"    function {f}(address payable[] calldata to) public {{",
            "        require(msg.sender == owner && to.length <= 10);",
            "        for (uint i = 0; i < to.length; i++) {",
            "            to[i].transfer(1);",
            "        }",
            "    }"]


def _distractor_origin_log(nm: _Names) -> List[str]:
    # tx.origin READ for logging — not used for authorization
    f = nm.fn()
    return [f"    function {f}() public view returns (bool) {{",
            "        return tx.origin == msg.sender;",
            "    }"]


_DISTRACTOR_BUILDERS = [_distractor_comment, _distractor_commented_code,
                        _distractor_string, _distractor_dead_code,
                        _distractor_safe_timestamp,
                        _distractor_safe_loop_call, _distractor_origin_log]


def _estimate_tokens(lines: List[str]) -> int:
    """Token count under the hermetic tokenizer's pretokenization (the same
    regex SolidityTokenizer/NativeSolidityTokenizer split on) — lets the
    generator hit a target length without importing a tokenizer."""
    from .tokenizer import _PRETOKEN_RE
    return sum(len(_PRETOKEN_RE.findall(l)) for l in lines)


def generate_contract(rng: random.Random,
                      vuln_types: Optional[List[str]] = None,
                      name: Optional[str] = None,
                      target_tokens: Optional[int] = None,
                      family: Optional[int] = None,
                      distractors: bool = False) -> Dict:
    """Generate one contract record with exact per-type vulnerable lines.

    ``target_tokens`` pads the contract with additional safe blocks (and
    occasional extra instances of the chosen vulnerability types) until it
    reaches roughly that many tokens. The reference's corpus is pre-filtered
    to 2048-token contracts (its CSV filename; eval notebook cell 10), so at
    max_length=1024 its batches carry essentially NO padding — and the
    contract head's unmasked mean-pool (SCT-GAN/model.py:462-466, a kept
    parity quirk) only works in that regime. Short contracts drown the
    pooled feature in padding embeddings; matching the reference's length
    distribution is a data property, not a model change.

    ``family`` (corpus v2) restricts vulnerable templates to one disjoint
    family (0, 1, or 2; None = all): train on one, evaluate on the others,
    so the benchmark measures template generalization. Family 2 is reserved
    as a never-trained column in the cross-family matrix. ``distractors`` mixes in
    vulnerable-LOOKING safe blocks (comments, strings, dead code,
    cross-type confusers) alongside the plain safe blocks."""
    if vuln_types is None:
        k = rng.randint(0, 3)
        vuln_types = rng.sample(VULNERABILITY_TYPES, k)
    name = name or f"Contract{rng.randint(0, 10**6)}"
    nm = _Names(rng)
    builders = (_FAMILIES[family] if family is not None else
                {vt: tuple(_VULN_BUILDERS[vt]) + tuple(_VULN_BUILDERS_F1[vt])
                 + tuple(_VULN_BUILDERS_F2[vt])
                 for vt in VULNERABILITY_TYPES})
    safe_pool = (_SAFE_BUILDERS + _DISTRACTOR_BUILDERS if distractors
                 else _SAFE_BUILDERS)

    lines: List[str] = [
        f"pragma solidity ^0.{rng.randint(4, 8)}.{rng.randint(0, 20)};",
        "",
        f"contract {name} {{",
        "    address public owner;",
        "    uint256 public total;",
        "    uint256 public rate;",
        "    uint256 public deadline;",
        "    uint256 public state;",
        "    bool public paused;",
        "    mapping(address => uint256) public balances;",
        "    mapping(address => uint256) public locked;",
        "    address payable[] public holders;",
        "    uint256 public dividend;",
        "",
        "    constructor() {",
        "        owner = msg.sender;",
        "    }",
        "",
    ]
    vuln_lines: Dict[str, List[int]] = {vt: [] for vt in VULNERABILITY_TYPES}

    blocks: List = []
    for vt in vuln_types:
        blocks.append(("vuln", vt))
    for _ in range(rng.randint(1, 3)):
        blocks.append(("safe", rng.randrange(len(safe_pool))))
    rng.shuffle(blocks)

    def _emit(kind, which) -> None:
        if kind == "vuln":
            builder = rng.choice(builders[which])
            snippet, rel = builder(nm)
            base = len(lines)
            lines.extend(snippet)
            vuln_lines[which].extend(base + r for r in rel)
        else:
            lines.extend(safe_pool[which](nm))
        lines.append("")

    for kind, which in blocks:
        _emit(kind, which)
    if target_tokens is not None:
        # grow with safe blocks (plus ~1-in-6 extra instances of an already-
        # chosen vuln type, mirroring real contracts repeating a pattern)
        # until the estimated token count reaches the target
        while _estimate_tokens(lines) < target_tokens:
            if vuln_types and rng.random() < 1.0 / 6.0:
                _emit("vuln", rng.choice(vuln_types))
            else:
                _emit("safe", rng.randrange(len(safe_pool)))
    lines.append("}")

    record: Dict = {
        "source_code": "\n".join(lines),
        "contract_name": name,
    }
    for vt in VULNERABILITY_TYPES:
        record[f"{vt}_lines"] = str(vuln_lines[vt])
    return record


def generate_corpus(n: int = 50, seed: int = 0,
                    target_tokens: Optional[Tuple[int, int]] = None,
                    family: Optional[int] = None,
                    distractors: bool = False) -> List[Dict]:
    """``target_tokens=(lo, hi)`` draws a per-contract length target
    uniformly from [lo, hi] — e.g. (950, 1250) reproduces the reference's
    fills-the-window length regime at max_length=1024.

    Corpus v2 recipe: ``generate_corpus(..., family=0, distractors=True)``
    for training, ``family=1, distractors=True`` (different seed) for the
    held-out-template eval split."""
    rng = random.Random(seed)
    return [generate_contract(
        rng, name=f"Synth{i}",
        target_tokens=(rng.randint(*target_tokens)
                       if target_tokens is not None else None),
        family=family, distractors=distractors)
        for i in range(n)]


def write_corpus_csv(path: str, n: int = 50, seed: int = 0,
                     target_tokens: Optional[Tuple[int, int]] = None,
                     family: Optional[int] = None,
                     distractors: bool = False) -> None:
    records = generate_corpus(n, seed, target_tokens=target_tokens,
                              family=family, distractors=distractors)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=list(records[0]),
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(records)
