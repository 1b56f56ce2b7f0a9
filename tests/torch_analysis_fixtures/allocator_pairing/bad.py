"""BAD fixture: a retained-page engine's acquisitions that leak."""


class Engine:
    def admit(self, rid, need, cancelled):
        self.allocator.reserve(rid, need)
        if cancelled(rid):
            return None  # the cancel path: the envelope stays charged
        self.allocator.release(rid)
        return rid

    def join_prefix(self, rid, pages, need):
        self.allocator.share(rid, pages)
        self.grow(rid, need)  # may raise: the shared pages leak
        self.allocator.release(rid)
