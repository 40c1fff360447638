"""The web demo (counterpart of `mcquic_tpu/service/`): `stCompressService`
holds the upload handler and its streamlit page, `cli` the stub the
reference's service CLI is."""
