"""Operations and bytes of the program's work, counted from shapes."""
