"""Pod health registry: which pods are alive, and how wide a rung may span.

A copy of ``repro/pod/health.py`` (pure Python).  Cross-pod rungs span a
*prefix* of the pod list, so rung usability is exactly
``prefix_healthy(p)``.  A pod marked lost filters the ladder
(``PodLadder.rung_for_batch``) and ``Trainer.demote`` moves the surviving
state down — no restart.
"""

from __future__ import annotations


class PodHealth:
    def __init__(self, num_pods: int):
        num_pods = int(num_pods)
        if num_pods < 1:
            raise ValueError(f"num_pods must be >= 1, got {num_pods}")
        self.num_pods = num_pods
        self._healthy = [True] * num_pods

    def _check(self, pod: int) -> int:
        pod = int(pod)
        if not 0 <= pod < self.num_pods:
            raise ValueError(f"pod {pod} out of range [0, {self.num_pods})")
        return pod

    def mark_lost(self, pod: int) -> None:
        self._healthy[self._check(pod)] = False

    def mark_healthy(self, pod: int) -> None:
        self._healthy[self._check(pod)] = True

    def is_healthy(self, pod: int) -> bool:
        return self._healthy[self._check(pod)]

    def prefix_healthy(self, k: int) -> bool:
        """True when pods ``0..k-1`` are ALL healthy (a k-pod rung is usable)."""
        k = int(k)
        if not 1 <= k <= self.num_pods:
            return False
        return all(self._healthy[:k])

    @property
    def healthy_prefix(self) -> int:
        """Length of the leading all-healthy run (0 when pod 0 is lost)."""
        n = 0
        for ok in self._healthy:
            if not ok:
                break
            n += 1
        return n

    @property
    def lost(self) -> list[int]:
        return [i for i, ok in enumerate(self._healthy) if not ok]

    def __repr__(self) -> str:
        bits = "".join("H" if ok else "L" for ok in self._healthy)
        return f"PodHealth({bits})"
