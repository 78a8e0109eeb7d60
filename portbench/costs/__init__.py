"""Operations and bytes of the cells' work, counted from the models'
shapes, for the rooflines and the MFU (the benchmark's own count)."""
