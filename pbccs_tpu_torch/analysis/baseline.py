"""Baseline suppressions for `ccs analyze` (analysis/baseline.toml).

The analyzer is a ratchet: the committed baseline names the findings the
repo has consciously decided to keep (an idiomatic write-mutex around a
socket send, a host-loop the jit lint cannot see through), each with a
reason, and everything else fails the gate.  Two hygiene properties are
enforced:

  * a suppression matches by (rule, path, message substring) -- never by
    line number, so unrelated edits above a finding do not invalidate it;
  * a suppression that matches NOTHING is itself a finding (ANA001):
    when the underlying code is fixed, the baseline entry must be
    deleted in the same PR, so the file never accumulates dead weight.

Inline `# ccs-analyze: ignore[RULE]` comments are the other suppression
channel -- right next to the code, for single-site exemptions; the
baseline is for findings whose justification deserves a paragraph.
"""

from __future__ import annotations

import dataclasses
import pathlib

from pbccs_tpu_torch.analysis.core import Finding

try:                      # Python 3.11+
    import tomllib as _toml
except ImportError:       # the image ships tomli on 3.10
    import tomli as _toml


@dataclasses.dataclass
class Suppression:
    rule: str
    path: str
    match: str = ""
    reason: str = ""
    pass_name: str = ""      # owning pass ("conc", "leases", ...)

    def covers(self, f: Finding) -> bool:
        return (f.rule == self.rule and f.path == self.path
                and (not self.match or self.match in f.message))


class BaselineError(ValueError):
    """Malformed baseline file (bad TOML, missing required keys, or an
    entry keyed on a rule/pass that no longer exists -- a retired rule
    makes every one of its suppressions permanently stale, so that is
    an error at load time, not a silent ANA001 later)."""


def load_baseline(path: pathlib.Path) -> list[Suppression]:
    from pbccs_tpu_torch.analysis import PASSES, RULES, pass_for_rule

    if not path.exists():
        return []
    try:
        data = _toml.loads(path.read_text())
    except _toml.TOMLDecodeError as e:
        raise BaselineError(f"{path}: {e}") from None
    out: list[Suppression] = []
    for i, entry in enumerate(data.get("suppress", [])):
        try:
            sup = Suppression(
                rule=entry["rule"], path=entry["path"],
                match=entry.get("match", ""),
                reason=entry.get("reason", ""),
                pass_name=entry.get("pass", ""))
        except (KeyError, TypeError) as e:
            raise BaselineError(
                f"{path}: suppress[{i}] needs string keys rule/path "
                f"(+optional match/reason/pass): {e!r}") from None
        if sup.rule not in RULES:
            raise BaselineError(
                f"{path}: suppress[{i}] names unknown rule "
                f"{sup.rule!r} (retired rules must take their "
                "suppressions with them)")
        if sup.pass_name:
            spec = PASSES.get(sup.pass_name)
            if spec is None:
                raise BaselineError(
                    f"{path}: suppress[{i}] names unknown pass "
                    f"{sup.pass_name!r}")
            if sup.rule not in spec.rules:
                raise BaselineError(
                    f"{path}: suppress[{i}] says rule {sup.rule} "
                    f"belongs to pass {sup.pass_name!r} but that pass "
                    f"owns {spec.rules}")
        else:
            sup.pass_name = pass_for_rule(sup.rule) or ""
        out.append(sup)
    return out


def apply_baseline(findings: list[Finding],
                   suppressions: list[Suppression],
                   baseline_rel: str) -> tuple[list[Finding], int]:
    """Filter suppressed findings; stale suppressions come back as
    ANA001 findings so the baseline can only shrink with the code."""
    kept: list[Finding] = []
    hit = [False] * len(suppressions)
    n_suppressed = 0
    for f in findings:
        covered = False
        for i, s in enumerate(suppressions):
            if s.covers(f):
                hit[i] = True
                covered = True
        if covered:
            n_suppressed += 1
        else:
            kept.append(f)
    for i, s in enumerate(suppressions):
        if not hit[i]:
            kept.append(Finding(
                "ANA001", baseline_rel, 1,
                f"stale suppression: rule={s.rule} path={s.path}"
                + (f" match={s.match!r}" if s.match else "")
                + " matches no current finding -- delete it"))
    return kept, n_suppressed
