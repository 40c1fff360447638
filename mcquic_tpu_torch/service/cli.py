"""Service CLI stub (reference `mcquic/service/cli.py:12-15` raises too)."""


def main(*args, **kwargs):
    raise NotImplementedError(
        "Run the web demo via `streamlit run mcquic_tpu_torch/service/stCompressService.py`.")
