"""GOOD fixture: a retained-page engine's acquisitions that pair."""


class Engine:
    def admit(self, rid, need, cancelled):
        try:
            self.allocator.reserve(rid, need)
            if cancelled(rid):
                return None
            return self.run(rid)
        finally:
            self.allocator.release(rid)

    def retain(self, rid, need):
        self.allocator.extend(rid, need)  # repro: transfer(allocator-pairing) — release_request frees it

    def record(self, rid, pages):
        self._pages.extend(pages)  # a list, not an allocator
