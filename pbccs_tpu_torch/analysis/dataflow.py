"""Path-sensitive statement walker for acquire/release-style invariants.

The engine executes one function body abstractly, carrying a set of
hashable semantic states through the control flow the acquire/release
passes care about:

  * `if`/`while` tests split the state (the semantics decides how --
    `if not self._try_acquire_slot(rid): return` puts the resource on
    exactly one branch);
  * `try` bodies know whether an enclosing handler/finally protects
    them; `raise` inside a try with handlers is treated as caught
    (conservative: narrow handlers count, so silence is not proof);
  * `finally` blocks run on EVERY exit path, including `return`/
    `raise`/`break` from inside the try -- the engine replays them
    before recording the exit;
  * loops iterate to a small fixpoint so a lease acquired on iteration
    N and released on iteration N+1 converges;
  * nested `def`/`lambda` bodies are NOT executed (another execution
    context); the semantics sees them once via `on_nested_def` (that is
    where closure-release callbacks register).

The engine is deliberately bounded: state sets cap at MAX_STATES via
deterministic repr-ordered truncation (a pathological function may
lose paths -- silence is not proof -- but never crashes, loops, or
varies across runs), and loop bodies re-execute at most LOOP_ROUNDS
times.

Semantics objects implement the hook protocol of `PathSemantics`; see
leases.py (resource leaks) and protolint.py (exactly-once completion)
for the two instantiations.
"""

from __future__ import annotations

import ast

MAX_STATES = 64
LOOP_ROUNDS = 4


class PathSemantics:
    """Hook protocol; every state must be hashable."""

    def initial_state(self):
        return ()

    def stmt_effect(self, stmt: ast.stmt, state):
        """Straight-line effect of a simple statement; return the new
        state, or a *list* of states to fork the path (states
        themselves may be tuples/frozensets -- only a list forks)."""
        return state

    def test_split(self, test: ast.expr, state):
        """(true_states, false_states) for a branch test."""
        return [state], [state]

    def on_nested_def(self, node, state):
        """A nested def/lambda statement was encountered (body not
        executed); return the new state."""
        return state

    def with_effect(self, node: ast.With, state):
        """Effect of entering a with statement (all items)."""
        return state

    def enter_try(self, node: ast.Try) -> None:
        """Body of `node` is about to execute (LIFO with exit_try)."""

    def try_is_swallowing_cleanup(self, node: ast.Try) -> bool:
        """True for the best-effort-cleanup idiom -- simple-statement
        body, every handler falls through without raising/returning --
        which executes as straight-line code: `try: fh.close()
        except OSError: pass` RELEASES the handle on every path (even
        a failing close settles the descriptor), so the handler must
        not resurrect the pre-release state."""
        if node.finalbody or node.orelse or not node.handlers:
            return False
        simple = (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Expr,
                  ast.Pass)
        if not all(isinstance(s, simple) for s in node.body):
            return False
        # handlers must DO nothing (pass only): a handler with effects
        # of its own is a real alternative path, not swallowed cleanup
        return all(all(isinstance(s, ast.Pass) for s in h.body)
                   for h in node.handlers)

    def exit_try(self, node: ast.Try) -> None:
        pass

    def on_exit(self, kind: str, node: ast.AST, state) -> None:
        """A path left the function: kind is "return", "raise" (only
        when uncaught locally) or "fall" (end of body)."""


class PathEngine:
    """Abstract executor; one instance per analyzed function."""

    def __init__(self, sem: PathSemantics):
        self.sem = sem
        # innermost-last: ("finally", stmts) | ("handlers",) |
        # ("loop", set_of_break_states)
        self.frames: list[tuple] = []

    # ------------------------------------------------------------- entry

    def run(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        out = self.exec_block(fn.body, {self.sem.initial_state()})
        for st in out:
            self.sem.on_exit("fall", fn, st)

    # ----------------------------------------------------------- helpers

    def _cap(self, states: set) -> set:
        if len(states) > MAX_STATES:
            # deterministic truncation (repr order): which states
            # survive must not depend on hash randomization, or the
            # same commit could flip between clean and failing runs
            states = set(sorted(states, key=repr)[:MAX_STATES])
        return states

    def _apply_finallies(self, state, upto_loop: bool = False):
        """Replay enclosing finally blocks (innermost first) onto
        `state` -- the effect a return/raise/break path observes.  With
        upto_loop, stop at the nearest loop frame (break semantics)."""
        states = {state}
        for frame in reversed(self.frames):
            if frame[0] == "loop" and upto_loop:
                break
            if frame[0] == "finally":
                # a finally that itself returns/raises is rare and
                # pathological; its linear effect is what matters here
                sub = PathEngine(self.sem)
                states = sub.exec_block(frame[1], states) or states
        return states

    def _caught_locally(self) -> bool:
        return any(f[0] == "handlers" for f in self.frames)

    # ------------------------------------------------------------ blocks

    def exec_block(self, stmts: list[ast.stmt], states: set) -> set:
        for stmt in stmts:
            nxt: set = set()
            for st in states:
                nxt |= self.exec_stmt(stmt, st)
            states = self._cap(nxt)
            if not states:
                break  # every path exited
        return states

    def exec_stmt(self, stmt: ast.stmt, state) -> set:
        sem = self.sem
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return {sem.on_nested_def(stmt, state)}
        if isinstance(stmt, ast.Return):
            for st in self._apply_finallies(state):
                sem.on_exit("return", stmt, st)
            return set()
        if isinstance(stmt, ast.Raise):
            if not self._caught_locally():
                for st in self._apply_finallies(state):
                    sem.on_exit("raise", stmt, st)
            return set()
        if isinstance(stmt, ast.Break):
            for frame in reversed(self.frames):
                if frame[0] == "loop":
                    frame[1].update(self._apply_finallies(
                        state, upto_loop=True))
                    break
            return set()
        if isinstance(stmt, ast.Continue):
            # approximated as jumping to the loop test: the loop-exit
            # union already includes every body fall-through state
            for frame in reversed(self.frames):
                if frame[0] == "loop":
                    frame[1].update(self._apply_finallies(
                        state, upto_loop=True))
                    break
            return set()
        if isinstance(stmt, ast.If):
            t, f = sem.test_split(stmt.test, state)
            out = self.exec_block(stmt.body, set(t))
            out |= self.exec_block(stmt.orelse, set(f))
            return out
        if isinstance(stmt, (ast.While, ast.For)):
            return self._exec_loop(stmt, state)
        if isinstance(stmt, ast.Try):
            if self.sem.try_is_swallowing_cleanup(stmt):
                out = {state}
                for s in stmt.body:
                    nxt: set = set()
                    for st in out:
                        r = sem.stmt_effect(s, st)
                        nxt |= set(r) if isinstance(r, list) else {r}
                    out = nxt
                return out
            return self._exec_try(stmt, state)
        if isinstance(stmt, ast.With) or isinstance(stmt, ast.AsyncWith):
            st2 = sem.with_effect(stmt, state)
            return self.exec_block(stmt.body, {st2})
        result = sem.stmt_effect(stmt, state)
        return set(result) if isinstance(result, list) else {result}

    def _exec_loop(self, stmt, state) -> set:
        sem = self.sem
        breaks: set = set()
        self.frames.append(("loop", breaks))
        try:
            if isinstance(stmt, ast.While):
                t, f = sem.test_split(stmt.test, state)
                entry, exits = set(t), set(f)
            else:
                st2 = sem.stmt_effect(stmt, state)
                entry = set(st2) if isinstance(st2, list) else {st2}
                exits = set(entry)   # zero-iteration exit
            seen: set = set()
            frontier = entry
            for _ in range(LOOP_ROUNDS):
                frontier = frontier - seen
                if not frontier:
                    break
                seen |= frontier
                out = self.exec_block(stmt.body, set(frontier))
                if isinstance(stmt, ast.While):
                    t, f = set(), set()
                    for st in out:
                        t2, f2 = sem.test_split(stmt.test, st)
                        t.update(t2)
                        f.update(f2)
                    exits |= f
                    frontier = t
                else:
                    exits |= out
                    frontier = out
        finally:
            self.frames.pop()
        exits |= breaks
        if stmt.orelse:
            exits = self.exec_block(stmt.orelse, exits)
        return self._cap(exits)

    def _exec_try(self, stmt: ast.Try, state) -> set:
        sem = self.sem
        sem.enter_try(stmt)
        if stmt.handlers:
            self.frames.append(("handlers",))
        if stmt.finalbody:
            self.frames.append(("finally", stmt.finalbody))
        try:
            body_out = self.exec_block(stmt.body, {state})
        finally:
            if stmt.finalbody:
                self.frames.pop()
            if stmt.handlers:
                self.frames.pop()
            sem.exit_try(stmt)
        # handlers run from the TRY-ENTRY state: an exception may fire
        # before any body effect landed (conservative for completion
        # counting; leak handling credits handler releases via the
        # protection set, not via these states)
        handler_out: set = set()
        if stmt.finalbody:
            self.frames.append(("finally", stmt.finalbody))
        try:
            for handler in stmt.handlers:
                handler_out |= self.exec_block(handler.body, {state})
        finally:
            if stmt.finalbody:
                self.frames.pop()
        if stmt.orelse:
            body_out = self.exec_block(stmt.orelse, body_out)
        out = body_out | handler_out
        if stmt.finalbody:
            out = self.exec_block(stmt.finalbody, out or {state})
        return self._cap(out)
