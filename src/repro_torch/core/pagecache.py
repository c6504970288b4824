"""Paged device-memory accounting (§5.2).

Device HBM is pre-divided into fixed pages; models occupy an integral number
of pages. Paging "simplifies choice": the controller mirrors each worker's
memory exactly by tracking a single integer (free pages) plus the resident
set. We extend the idea to KV-cache pages for LM serving (DESIGN.md §2).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

PAGE_BYTES = 16 * 1024 * 1024      # 16 MB, as in the paper


class PageCache:
    def __init__(self, total_bytes: int, page_bytes: int = PAGE_BYTES):
        self.page_bytes = page_bytes
        self.total_pages = int(total_bytes // page_bytes)
        self.free_pages = self.total_pages
        self.resident: Dict[str, int] = {}       # model_id -> pages held
        # LRU order as an insertion-ordered dict used as a set: O(1)
        # touch/free instead of the O(n) list.remove on every EXEC
        self._lru: Dict[str, None] = {}           # least-recent first
        # optional hook fired when the resident *set* changes (model, added);
        # the controller uses it to keep a cluster-wide residency index in
        # sync with its mirrors, whoever mutates them
        self.on_resident_change = None

    @staticmethod
    def pages_for(nbytes: int, page_bytes: int = PAGE_BYTES) -> int:
        return max(1, math.ceil(nbytes / page_bytes))

    def contains(self, model_id: str) -> bool:
        return model_id in self.resident

    def can_alloc(self, pages: int) -> bool:
        return self.free_pages >= pages

    def alloc(self, model_id: str, pages: int) -> bool:
        if model_id in self.resident:
            self.touch(model_id)
            return True
        if self.free_pages < pages:
            return False
        self.free_pages -= pages
        self.resident[model_id] = pages
        self._lru[model_id] = None
        if self.on_resident_change is not None:
            self.on_resident_change(model_id, True)
        return True

    def free(self, model_id: str) -> int:
        pages = self.resident.pop(model_id, 0)
        self.free_pages += pages
        self._lru.pop(model_id, None)
        if pages and self.on_resident_change is not None:
            self.on_resident_change(model_id, False)
        return pages

    def touch(self, model_id: str):
        if model_id in self._lru:
            del self._lru[model_id]
            self._lru[model_id] = None

    def lru_candidate(self, exclude=()) -> Optional[str]:
        for m in self._lru:
            if m not in exclude:
                return m
        return None

    def used_pages(self) -> int:
        return self.total_pages - self.free_pages

    def utilization(self) -> float:
        return self.used_pages() / max(self.total_pages, 1)
