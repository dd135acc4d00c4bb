"""Operations and bytes that the work needs, counted from shapes (one
module per problem), and the card's published peaks (``peaks.py``)."""
