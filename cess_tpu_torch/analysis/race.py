"""race: cross-thread field writes must share a lock guard.

lock_discipline checks per-file *consistency* ("this attr is usually
written under self._lock — here it is not") but cannot see WHICH
threads reach a write, so a field that two threads hammer lock-free
is invisible as long as it is consistently lock-free. The flow
layer's thread-root attribution closes that gap, RacerD-style
(Blackshear et al., OOPSLA '18): no whole-program alias analysis,
just ownership-ish roots plus lock sets.

A finding requires ALL of:
- the field is written from >= 2 distinct thread roots (batcher
  loops spawned via ``Thread(target=...)``, registered listeners/
  callbacks, and the public ``caller`` root) — single-writer/
  multi-reader is exempt by construction;
- the lock-set intersection over those writes is empty — writes that
  all share one guard are fine, as are ``*_locked`` helpers (the
  caller holds the guard by convention, trusted exactly as
  lock_discipline trusts them);
- the write is post-publication — ``__init__``/``__new__`` run
  before any thread can see the object and are exempt.
"""
from __future__ import annotations

from .core import Finding, ParsedModule, Rule, register
from .flow import CALLER_ROOT, flow_graph
from .lock_discipline import _classes


@register
class CrossThreadRace(Rule):
    id = "race"
    description = ("field written from >= 2 thread roots without a "
                   "common lock guard")
    hint = ("hold one consistent lock around every cross-thread "
            "write (or move the write into the owning thread's loop "
            "and publish via a queue); pre-start writes belong in "
            "__init__")

    def applies(self, path: str) -> bool:
        return True              # package-wide: thread roots cross files

    def check_project(self, mods: list[ParsedModule]) -> list[Finding]:
        graph = flow_graph(mods)
        out: list[Finding] = []
        for mod in mods:
            for cls in _classes(mod):
                ci = graph._classes_by_path.get((mod.path, cls.name))
                if ci is None:
                    continue
                roots = graph.method_roots(ci)
                by_attr: dict[str, list] = {}
                for w in cls.writes:
                    if w.method in ("__init__", "__new__"):
                        continue     # pre-publication
                    if w.attr in cls.lock_attrs:
                        continue     # the locks themselves
                    by_attr.setdefault(w.attr, []).append(w)
                for attr, writes in sorted(by_attr.items()):
                    writer_roots: set[str] = set()
                    for w in writes:
                        writer_roots |= roots.get(w.method,
                                                  {CALLER_ROOT})
                    if len(writer_roots) < 2:
                        continue     # single-writer/multi-reader
                    common = None    # None == universal set so far
                    culprit = writes[0]
                    for w in writes:
                        if w.held is None:
                            continue   # *_locked: caller holds guard
                        if common is None:
                            common = set(w.held)
                        else:
                            common &= w.held
                        if not w.held:
                            culprit = w
                    if common is None or common:
                        continue     # consistently guarded (or all
                        #              caller-held by convention)
                    names = ", ".join(sorted(writer_roots))
                    held = ", ".join(sorted(culprit.held or ())) \
                        or "no lock"
                    out.append(self.finding(
                        mod, culprit.node,
                        f"`{cls.name}.{attr}` is written from "
                        f"{len(writer_roots)} thread roots ({names}) "
                        f"with no common lock — this write holds "
                        f"{held}"))
        return out
