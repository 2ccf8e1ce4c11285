from repro_torch.data.pipeline import (DataLoader, DataState, MMapTokens,
                                       SyntheticTokens, local_rows)

__all__ = ["DataLoader", "DataState", "MMapTokens", "SyntheticTokens", "local_rows"]
