"""The general drivers, one per traffic kind (a mix's ``kind``): ``train``
loops the program's train epochs over a window, ``serve`` offers open-loop
requests to a resident predictor at the mix's fixed rate."""
