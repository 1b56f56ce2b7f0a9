"""GOOD fixture: every guard form over the port's serving loop."""


class Backend:
    def run_batch(self, batch):
        if self.obs.enabled:
            self.obs.on_batch(batch)
        return batch

    def finish(self, batch):
        if not self.core.obs.enabled:
            return
        self.core.obs.on_finish(batch)
