"""``launch.serve.generate``: the port's LM serving path (``lm.prefill_step``,
then a ``lm.decode_step`` a token) over one prompt batch, greedy, with the
compared logits kept on the card and brought back with the tokens.

The configuration's generator gives the port's config (``model_config``)
and the weights, the port's tree under ``shared["program"]``."""

from __future__ import annotations

from portbench import drive, spec


class Entry(drive.Entry):

    def __init__(self, *args) -> None:
        super().__init__(*args)
        from repro_torch.launch import serve
        self.serve = serve
        self.cfg = spec.generator(
            self.config["data"]["generator"]).model_config(self.config)

    def run(self, j: int):
        return self.serve.generate(self.shared["program"],
                                   self.data[self.dataset(j)], self.cfg,
                                   gen=int(self.config["gen"]),
                                   keep_logits=True)

    def fetch(self, result, keep: bool) -> dict:
        return {"tokens": self.host("tokens", result["generated"], keep),
                "logits": self.host("logits", result["logits"], keep)}
