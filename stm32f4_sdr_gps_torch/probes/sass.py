"""A kernel library's SASS, read: its functions' instructions
(``cuobjdump -sass``), their control flow, and the register dependencies
of a loop body.  chip_smoke.py checks the kernels' SASS with these (P8's
col kernels, the roll kernels) and prices P6's chains from it."""

from __future__ import annotations

import re
import shutil
import subprocess

_FUNC = re.compile(r"Function : (\S+)")
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
_TARGET = re.compile(r"0x([0-9a-f]+)\s*$")
# general, predicate and uniform registers (RZ, PT, URZ and UPT are none)
_REG = re.compile(r"\bU?(?:R\d+|P\d)\b")
_PRED = re.compile(r"!?U?P(?:\d|T)")


def dump(path: str) -> str:
    """``cuobjdump -sass`` of a shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def functions(sass: str, pattern: str) -> dict:
    """For each function whose (mangled) name matches the regex
    ``pattern``, its instructions as (address, text) pairs, keyed by the
    match's groups (the whole name where it has none)."""
    funcs, cur = {}, None
    for line in sass.splitlines():
        head = _FUNC.search(line)
        if head:
            m = re.search(pattern, head.group(1))
            cur = (m.groups() or (head.group(1),)) if m else None
            if cur is not None:
                funcs[cur] = []
            continue
        op = _INS.search(line)
        if cur is not None and op:
            funcs[cur].append((int(op.group(1), 16), op.group(2)))
    return funcs


def opcode(text: str) -> str:
    """An instruction's opcode with its modifiers, without its predicate."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def successors(ins: list) -> list:
    """For one function's (address, text) pairs, each instruction's
    successors: the next one (unless it is an unconditional BRA, EXIT or
    RET) and a branch's target."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    succ = []
    for i, (_, text) in enumerate(ins):
        pred = text.split()[0].startswith("@") if text.split() else False
        op = opcode(text)
        nxt = []
        tgt = _TARGET.search(text)
        if op.startswith("BRA") and tgt and int(tgt[1], 16) in index:
            nxt.append(index[int(tgt[1], 16)])
        if not ((op == "BRA" and not pred and "," not in text)
                or (op in ("EXIT", "RET", "RET.REL") and not pred)):
            nxt.append(i + 1)
        succ.append([j for j in nxt if j < len(ins)])
    return succ


def on_cycle(succ: list, i: int) -> bool:
    """Whether instruction i can reach itself: it lies in a loop."""
    seen, todo = set(), list(succ[i])
    while todo:
        j = todo.pop()
        if j == i:
            return True
        if j not in seen:
            seen.add(j)
            todo.extend(succ[j])
    return False


def inner_loops(ins: list) -> list:
    """(first, last) instruction indices of each loop closed by a
    backward branch (``last`` the branch) that holds no other such loop."""
    index = {a: i for i, (a, _) in enumerate(ins)}
    loops = []
    for i, (_, text) in enumerate(ins):
        tgt = _TARGET.search(text)
        if opcode(text).startswith("BRA") and tgt:
            j = index.get(int(tgt[1], 16))
            if j is not None and j <= i:
                loops.append((j, i))
    return [(s, e) for s, e in loops
            if not any(s <= s2 and e2 < e for s2, e2 in loops)]


def registers(operand: str) -> set:
    """The registers an operand names (R, P, UR, UP; not RZ or PT)."""
    return set(_REG.findall(operand))


def deps(text: str) -> tuple:
    """(written, read) registers of one instruction: the first operand
    and the predicates right after it are written (a store's address is
    read), the rest and the guard predicate read."""
    text = text.strip()
    read = set()
    if text.startswith("@"):
        guard, text = text.split(None, 1)
        read |= registers(guard)
    parts = text.split(None, 1)
    ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
    written, i = set(), 0
    if ops and not ops[0].startswith("[") and not parts[0].startswith(
            ("ST", "BRA", "EXIT", "RET")):
        written |= registers(ops[0])
        i = 1
        while i < len(ops) and _PRED.fullmatch(ops[i]):
            written |= registers(ops[i])
            i += 1
    for o in ops[i:]:
        read |= registers(o)
    return written, read


def depth_per_trip(body: list, warm: int = 4, trips: int = 8) -> float:
    """The steady growth, in instructions per trip, of the longest chain
    of register dependencies when the loop body ``body`` (instruction
    texts, the back branch left out) runs trip after trip: each
    instruction ready one step after the last of the registers it reads."""
    ready, depth = {}, []
    insts = [deps(t) for t in body]
    for _ in range(warm + trips):
        for written, read in insts:
            t = max((ready.get(r, 0) for r in read), default=0) + 1
            for w in written:
                ready[w] = t
        depth.append(max(ready.values(), default=0))
    return (depth[-1] - depth[warm - 1]) / trips


def loop_control(body: list) -> int:
    """How many instructions of a loop body keep the loop itself: the
    branch, the integer compares (ISETP) and the instructions that write
    only registers those compares read (the trip counter)."""
    cmp_read = set()
    for t in body:
        if opcode(t).startswith("ISETP"):
            cmp_read |= deps(t)[1]
    n = 0
    for t in body:
        op = opcode(t)
        written = deps(t)[0]
        n += (op.startswith(("BRA", "ISETP"))
              or bool(written and written <= cmp_read))
    return n
