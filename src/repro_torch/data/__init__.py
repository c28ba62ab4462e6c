from repro_torch.data.synthetic import TokenStream

__all__ = ["TokenStream"]
