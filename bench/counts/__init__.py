"""Operations and bytes the benchmark counts from shapes alone, and the
card's peaks they are held against."""
