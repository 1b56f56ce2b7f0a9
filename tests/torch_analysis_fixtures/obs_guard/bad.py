"""BAD fixture: hooks of the port's serving loop without their guard."""


class Backend:
    def run_batch(self, batch):
        self.obs.on_batch(batch)
        return batch

    def finish(self, batch):
        if self.core.obs.enabled:
            self.obs.on_finish(batch)
