"""Operations and bytes of each kernel and of each model, from the widths
and the work that a cell's traffic asks for; the card's peaks."""
