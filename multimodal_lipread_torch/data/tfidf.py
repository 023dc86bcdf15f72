"""TF-IDF features for the cue pipeline's ``linear`` model (the port's own
copy of what the JAX package takes from scikit-learn:
``TfidfVectorizer(max_features=5000, ngram_range=(1, 2),
stop_words="english")`` with its other settings at their defaults).

Step by step as scikit-learn computes it:

1. lowercase each document and take the tokens ``(?u)\\b\\w\\w+\\b``;
2. drop scikit-learn's English stop words (the list below, copied);
3. the 1-grams, then the 2-grams of the remaining tokens, joined by a space;
4. count each term per document; the vocabulary is sorted;
5. keep at most ``max_features`` terms: the most frequent over the corpus,
   chosen by the same ``(-tfs).argsort()[:limit]`` over the sorted
   vocabulary, so ties at the cut break as scikit-learn's do;
6. smooth idf ``ln((1 + n) / (1 + df)) + 1``, multiplied into the counts;
7. each row scaled to unit L2 norm (a row without terms stays zero).

The counts, sums and idf are float64, as scikit-learn's; ``fit_transform``
returns a dense float64 array.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# scikit-learn's ENGLISH_STOP_WORDS (sklearn/feature_extraction/_stop_words.py)
ENGLISH_STOP_WORDS = frozenset("""
    a about above across after afterwards again against all almost alone along
    already also although always am among amongst amoungst amount an and another any
    anyhow anyone anything anyway anywhere are around as at back be became because
    become becomes becoming been before beforehand behind being below beside besides
    between beyond bill both bottom but by call can cannot cant co con could couldnt
    cry de describe detail do done down due during each eg eight either eleven else
    elsewhere empty enough etc even ever every everyone everything everywhere except
    few fifteen fifty fill find fire first five for former formerly forty found four
    from front full further get give go had has hasnt have he hence her here
    hereafter hereby herein hereupon hers herself him himself his how however
    hundred i ie if in inc indeed interest into is it its itself keep last latter
    latterly least less ltd made many may me meanwhile might mill mine more moreover
    most mostly move much must my myself name namely neither never nevertheless next
    nine no nobody none noone nor not nothing now nowhere of off often on once one
    only onto or other others otherwise our ours ourselves out over own part per
    perhaps please put rather re same see seem seemed seeming seems serious several
    she should show side since sincere six sixty so some somehow someone something
    sometime sometimes somewhere still such system take ten than that the their them
    themselves then thence there thereafter thereby therefore therein thereupon
    these they thick thin third this those though three through throughout thru thus
    to together too top toward towards twelve twenty two un under until up upon us
    very via was we well were what whatever when whence whenever where whereafter
    whereas whereby wherein whereupon wherever whether which while whither who
    whoever whole whom whose why will with within without would yet you your yours
    yourself yourselves
""".split())

_TOKEN_RE = re.compile(r"(?u)\b\w\w+\b")


class TfidfVectorizer:
    """Fit on a corpus and weigh it (see the module docstring)."""

    def __init__(self, max_features: Optional[int] = 5000):
        self.max_features = max_features
        self.vocabulary_: Dict[str, int] = {}
        self.idf_: Optional[np.ndarray] = None

    @staticmethod
    def analyze(doc: str) -> List[str]:
        """A document's 1- and 2-grams, in scikit-learn's order."""
        tokens = [t for t in _TOKEN_RE.findall(doc.lower()) if t not in ENGLISH_STOP_WORDS]
        return tokens + [f"{a} {b}" for a, b in zip(tokens, tokens[1:])]

    def _counts(self, docs: Sequence[str]) -> np.ndarray:
        counts = np.zeros((len(docs), len(self.vocabulary_)), np.float64)
        for i, doc in enumerate(docs):
            for term in self.analyze(doc):
                j = self.vocabulary_.get(term)
                if j is not None:
                    counts[i, j] += 1.0
        return counts

    def fit_transform(self, docs: Sequence[str]) -> np.ndarray:
        terms = sorted({t for doc in docs for t in self.analyze(doc)})
        if not terms:
            raise ValueError("empty vocabulary; perhaps the documents only contain stop words")
        self.vocabulary_ = {t: j for j, t in enumerate(terms)}
        counts = self._counts(docs)
        if self.max_features is not None and len(terms) > self.max_features:
            tfs = counts.sum(axis=0)
            keep = np.zeros(len(terms), bool)
            keep[(-tfs).argsort()[: self.max_features]] = True
            terms = [t for t, k in zip(terms, keep) if k]
            self.vocabulary_ = {t: j for j, t in enumerate(terms)}
            counts = counts[:, keep]
        df = (counts > 0).sum(axis=0).astype(np.float64)
        self.idf_ = np.log((len(docs) + 1.0) / (df + 1.0)) + 1.0
        x = counts * self.idf_
        norms = np.sqrt((x * x).sum(axis=1, keepdims=True))
        return np.divide(x, norms, out=np.zeros_like(x), where=norms > 0)
