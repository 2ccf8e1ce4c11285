from repro_torch.data.pipeline import (DataLoader, DataState, MMapTokens,
                                       SyntheticTokens)

__all__ = ["DataLoader", "DataState", "MMapTokens", "SyntheticTokens"]
