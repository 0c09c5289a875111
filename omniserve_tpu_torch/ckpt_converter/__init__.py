"""Offline checkpoint tools of the port: the QoQ fake-quant dump ->
``packed.npz`` converter (``convert``) and a fake-quant dump maker for
exercising it on any local HF checkpoint (``make_fake_quant_dump``)."""
