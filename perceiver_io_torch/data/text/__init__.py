from perceiver_io_torch.data.text.collator import Collator, DefaultCollator, RandomTruncateCollator
from perceiver_io_torch.data.text.common import (
    CLMDataset,
    ClfDataset,
    RandomShiftDataset,
    Task,
    TextDataModule,
    TextPreprocessor,
)
from perceiver_io_torch.data.text.synthetic import MarkovByteSource, SyntheticTextDataModule, python_source_corpus
from perceiver_io_torch.data.text.tokenizer import ByteTokenizer, get_tokenizer
